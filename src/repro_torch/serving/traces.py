"""Deterministic request-arrival traces for the serving plane.

A trace is a list of :class:`Request` objects — arrival time, prompt and
generation lengths, priority — produced by a *named* generator so a
``JobSpec`` can reference the workload shape over the wire ("steady",
"burst", "poisson") instead of shipping the request list itself.  All
generators are seeded and pure: the same (name, n, seed, shape params)
always yields byte-identical traces, which is what makes the sim/real
parity tests and the benchmark gate reproducible.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: arrives at ``arrival`` (virtual seconds),
    carries a ``prompt_len``-token prompt and wants ``gen_len`` generated
    tokens.  ``priority`` feeds the prefill-burst admission queue."""

    rid: str
    arrival: float
    prompt_len: int
    gen_len: int
    priority: float = 1.0

    @property
    def total_tokens(self) -> int:
        return self.prompt_len + self.gen_len


def _lengths(rng: random.Random, n: int, prompt_len: int, gen_len: int,
             uniform: bool) -> List[tuple]:
    """Per-request (prompt, gen) lengths.  ``uniform`` pins every request
    to the mean (the real engine's cohort decode needs position-aligned
    waves); otherwise lengths jitter +-50 % around the mean."""
    if uniform:
        return [(prompt_len, gen_len)] * n
    out = []
    for _ in range(n):
        p = max(1, int(prompt_len * (0.5 + rng.random())))
        g = max(1, int(gen_len * (0.5 + rng.random())))
        out.append((p, g))
    return out


def make_trace(name: str, n_requests: int, *, seed: int = 0,
               prompt_len: int = 8, gen_len: int = 8,
               mean_gap: float = 0.002, priority: float = 1.0,
               uniform_lengths: bool = True) -> List[Request]:
    """Build the named arrival trace.

    ``steady``  — one request every ``mean_gap`` seconds.
    ``burst``   — all requests arrive at t=0 (the prefill-burst admission
                  stressor: a flash crowd into a decode-heavy mix).
    ``poisson`` — exponential inter-arrival gaps with mean ``mean_gap``.
    """
    rng = random.Random(seed)
    lens = _lengths(rng, n_requests, prompt_len, gen_len, uniform_lengths)
    if name == "steady":
        arrivals = [i * mean_gap for i in range(n_requests)]
    elif name == "burst":
        arrivals = [0.0] * n_requests
    elif name == "poisson":
        t, arrivals = 0.0, []
        for _ in range(n_requests):
            arrivals.append(t)
            t += rng.expovariate(1.0 / mean_gap)
    else:
        raise ValueError(f"unknown request trace {name!r} "
                         "(known: steady, burst, poisson)")
    return [Request(rid=f"r{i}", arrival=arrivals[i], prompt_len=lens[i][0],
                    gen_len=lens[i][1], priority=priority)
            for i in range(n_requests)]


TRACE_NAMES = ("steady", "burst", "poisson")
