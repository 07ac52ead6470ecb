"""KvResidencyPass: plan KV-block evict/prefetch against the decode timeline.

Training passes (``core/passes.py``) plan against a *fixed iteration DAG*:
every tensor access is known up front, so a plan is a list of (trigger op,
delta) events replayed each iteration.  Serving breaks that assumption —
the timeline is a rolling, request-driven horizon: sequences arrive, grow a
block per ``block_tokens`` decoded tokens, and finish, so the planner runs
*per decode turn* over the current continuous-batching state instead of
once per plan version.

The decode timeline it plans against is the cohort rotation: live
sequences group by cache position (the model's decode step takes one scalar
index, so a cohort must be position-aligned), and groups take decode turns
round-robin, least-recently-served first.  Under budget pressure the pass

* caps the cohort at what fits the serving job's arbiter slice,
* evicts the *coldest* resident sequences — the ones whose next decode
  turn is farthest in the rotation (the serving analogue of TENSILE's
  largest-reuse-distance victim rule), and
* books prefetches on the shared ``DmaChannel`` for the *next* group in
  the rotation, overlapped with the current turn's compute so the blocks
  land before their decode turn starts (swap-in ahead of the access,
  paper §IV-B, with the trigger being a decode turn instead of an op).

The pass is pure: ``plan_turn`` reads table + sequence state and returns a
:class:`TurnPlan`; the session executes it.  Determinism here is what the
sim/real parity test pins — both runtimes replay identical decisions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from .blocks import BlockTable


@dataclasses.dataclass
class SeqView:
    """What the planner may know about one live sequence."""

    rid: str
    slot: int
    pos: int                 # tokens already in the cache (prompt + generated)
    remaining: int           # generation tokens still wanted
    last_served: float = -1.0  # virtual time of its group's last decode turn


@dataclasses.dataclass
class DecodeTurn:
    """One upcoming decode turn: a position-aligned group of sequences."""

    pos: int
    rids: List[str]


@dataclasses.dataclass
class DecodeHorizon:
    """The rolling lookahead: cohort groups in rotation order.  Index 0 is
    the turn being planned; higher indices are colder."""

    turns: List[DecodeTurn]

    def distance(self, rid: str) -> int:
        for i, turn in enumerate(self.turns):
            if rid in turn.rids:
                return i
        return len(self.turns)


@dataclasses.dataclass
class TurnPlan:
    """The pass's decision for one decode turn."""

    cohort: List[SeqView]            # sequences decoding this turn
    evict: List[str]                 # rids to swap out before the turn
    fetch: List[str]                 # cohort rids whose blocks MUST come
    #                                  back from host before the turn
    prefetch: List[str]              # lookahead rids swapped in during it
    chunk: int                       # tokens each cohort member decodes
    horizon: DecodeHorizon


def build_horizon(seqs: Sequence[SeqView]) -> DecodeHorizon:
    """Group live sequences by cache position; order groups by how long
    ago they were served (oldest first), then by position and lead slot —
    a deterministic round-robin rotation."""
    groups: Dict[int, List[SeqView]] = {}
    for s in seqs:
        groups.setdefault(s.pos, []).append(s)
    ordered = sorted(
        groups.values(),
        key=lambda g: (min(s.last_served for s in g), g[0].pos,
                       min(s.slot for s in g)))
    return DecodeHorizon(turns=[
        DecodeTurn(pos=g[0].pos, rids=[s.rid for s in sorted(
            g, key=lambda s: s.slot)]) for g in ordered])


class KvResidencyPass:
    """Plans block residency for one decode turn at a time."""

    def __init__(self, table: BlockTable, budget_bytes: Optional[int],
                 chunk_tokens: Optional[int] = None):
        self.table = table
        self.budget = budget_bytes
        self.chunk_tokens = chunk_tokens or table.block_tokens

    # -- per-sequence byte math ----------------------------------------

    def _working_set(self, s: SeqView, chunk: int) -> int:
        """Device bytes sequence ``s`` needs while decoding ``chunk``
        tokens: its whole cache (attention reads every position) plus the
        blocks the chunk grows into."""
        return self.table.footprint(s.pos + chunk)

    # -- the planning rule ---------------------------------------------

    def plan_turn(self, seqs: Sequence[SeqView]) -> Optional[TurnPlan]:
        """Decide the next decode turn.  Returns None when nothing is
        live.  Called once per turn by the session — the rolling-horizon
        replacement for a per-plan-version pipeline run."""
        live = [s for s in seqs if s.remaining > 0]
        if not live:
            return None
        horizon = build_horizon(live)
        by_rid = {s.rid: s for s in live}
        group = [by_rid[r] for r in horizon.turns[0].rids]
        chunk = min(self.chunk_tokens, min(s.remaining for s in group))

        # cohort: greedily take the group's sequences (slot order) while
        # their combined working set fits the budget; always at least one
        cohort: List[SeqView] = []
        need = 0
        for s in group:
            w = self._working_set(s, chunk)
            if cohort and self.budget is not None and need + w > self.budget:
                break
            cohort.append(s)
            need += w
        cohort_ids = {s.rid for s in cohort}
        chunk = min(chunk, min(s.remaining for s in cohort))

        # cohort members whose blocks were evicted while they were cold
        # must be fetched back before the turn — their access came due
        fetch = [s.rid for s in cohort if self.table.host_bytes(s.rid) > 0]
        if self.budget is None:
            return TurnPlan(cohort=cohort, evict=[], fetch=fetch,
                            prefetch=[], chunk=chunk, horizon=horizon)

        # project device usage through the turn: live bytes + the blocks
        # the chunk grows into + the mandatory fetches landing on device;
        # evict coldest resident non-cohort sequences until it fits
        growth = sum(max(self._working_set(s, chunk)
                         - self.table.device_bytes(s.rid)
                         - self.table.host_bytes(s.rid), 0) for s in cohort)
        projected = (self.table.view.used + growth
                     + sum(self.table.host_bytes(r) for r in fetch))
        victims = sorted(
            (s for s in live if s.rid not in cohort_ids
             and self.table.device_bytes(s.rid) > 0),
            key=lambda s: (-horizon.distance(s.rid), -s.slot))
        evict: List[str] = []
        for v in victims:
            if projected <= self.budget:
                break
            projected -= self.table.device_bytes(v.rid)
            evict.append(v.rid)

        # prefetch the next turn's group if its blocks are parked on host
        # and the post-eviction projection leaves room for them
        prefetch: List[str] = []
        for turn in horizon.turns[1:2]:
            for rid in turn.rids:
                hb = self.table.host_bytes(rid)
                if hb and rid not in evict \
                        and projected + hb <= self.budget:
                    prefetch.append(rid)
                    projected += hb
        return TurnPlan(cohort=cohort, evict=evict, fetch=fetch,
                        prefetch=prefetch, chunk=chunk, horizon=horizon)

    # -- batched transfer emission -------------------------------------

    def transfer_cohorts(self, plan: TurnPlan) -> Dict[str, list]:
        """Distill a :class:`TurnPlan` into direction-grouped transfer
        cohorts, ``{"evict"|"fetch"|"prefetch": [(rid, nbytes), ...]}``
        with zero-byte members dropped — each group is one coalesced
        ``DmaChannel.acquire_batch`` booking for a batching session
        (single fixup latency for the whole cohort)."""
        ev = [(r, self.table.device_bytes(r)) for r in plan.evict]
        fe = [(r, self.table.host_bytes(r)) for r in plan.fetch]
        pf = [(r, self.table.host_bytes(r)) for r in plan.prefetch]
        return {"evict": [(r, b) for r, b in ev if b > 0],
                "fetch": [(r, b) for r, b in fe if b > 0],
                "prefetch": [(r, b) for r, b in pf if b > 0]}
