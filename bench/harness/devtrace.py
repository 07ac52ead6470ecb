"""Device time from ``torch.profiler`` over a window of whole steps.

``profile(fn)`` runs ``fn`` under the profiler (CPU and CUDA activities)
and reduces the trace: the union of the intervals in which any device
operation ran (kernels, copies, fills: ``busy_s``), the union of the host
and device copies' intervals (``copy_s``), the window's length (the host
clock's around ``fn`` and its synchronisation, or the trace's span if that
is longer), the device operations with the most time, and the longest
gaps in which the device ran nothing, each named by the shortest host
operation that covers most of the gap.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, List, Tuple

import torch

COPY_NAMES = ("Memcpy HtoD", "Memcpy DtoH")
TOP = 10


def union_seconds(spans: List[Tuple[float, float]]) -> float:
    """The length of the union of ``spans`` (start, end) in microseconds,
    as seconds."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e6


def gaps(spans: List[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] that no span covers."""
    out, cur = [], lo
    for a, b in sorted(spans):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [g for g in out if g[1] > g[0]]


def _host_label(gap, host) -> str:
    """The host operation that covers most of ``gap``, the shortest of
    those that cover as much."""
    best, best_key = "host", (0.0, 0.0)
    for a, b, name in host:
        cover = min(b, gap[1]) - max(a, gap[0])
        if cover <= 0:
            continue
        key = (cover, -(b - a))
        if key > best_key:
            best, best_key = name, key
    return best


def profile(fn: Callable[[], None]) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    sync()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_s = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        span = (tr.start, tr.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(span + (e.name,))
        else:
            host.append(span + (e.name,))
    spans = [(a, b) for a, b, _ in dev]
    if not spans:
        return {"window_s": wall_s, "busy_s": 0.0, "copy_s": 0.0,
                "device_ops": 0, "top_ops": [], "idle_gaps": []}
    lo = min(a for a, _, _ in host + dev)
    hi = max(b for _, b, _ in host + dev)
    by_name = collections.Counter()
    for a, b, name in dev:
        by_name[name[:80]] += (b - a) / 1e6
    idle = sorted(gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    # gaps of the same host operation are summed under its name
    idle_named = collections.Counter()
    for g in idle:
        idle_named[_host_label(g, host)[:80]] += (g[1] - g[0]) / 1e6
    return {"window_s": max(wall_s, (hi - lo) / 1e6),
            "busy_s": union_seconds(spans),
            "copy_s": union_seconds([(a, b) for a, b, n in dev
                                     if any(c in n for c in COPY_NAMES)]),
            "device_ops": len(dev),
            "top_ops": [[n, s] for n, s in by_name.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in idle_named.most_common(TOP)]}
