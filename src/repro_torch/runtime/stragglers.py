"""Straggler detection & mitigation.

On a 1000+-node pod, slow hosts (thermal throttling, failing HBM, noisy
neighbours) stretch every synchronous step to the slowest participant.
This module gives the training loop:

  * per-host step-time collection (`record`),
  * robust z-score detection against the rolling fleet median,
  * mitigation hooks: `rebalance()` proposes a data-shard reassignment
    (shrink the straggler's shard), and `should_evict()` flags hosts for
    replacement when they stay slow — the coordinator then triggers the
    elastic-restore path (runtime.elastic).
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass
class StragglerConfig:
    window: int = 20          # rolling steps per host
    z_threshold: float = 3.0  # robust z-score to flag
    evict_after: int = 10     # consecutive flagged steps before eviction
    min_samples: int = 5


class StragglerMonitor:
    def __init__(self, n_hosts: int, config: Optional[StragglerConfig] = None):
        self.n_hosts = n_hosts
        self.cfg = config or StragglerConfig()
        self.times: Dict[int, Deque[float]] = {
            h: collections.deque(maxlen=self.cfg.window)
            for h in range(n_hosts)}
        self.flag_streak: Dict[int, int] = {h: 0 for h in range(n_hosts)}

    # ------------------------------------------------------------------
    def record(self, host: int, step: int, seconds: float) -> None:
        self.times.setdefault(
            host, collections.deque(maxlen=self.cfg.window)).append(seconds)

    def host_median(self, host: int) -> Optional[float]:
        t = self.times.get(host)
        return statistics.median(t) if t else None

    def stragglers(self) -> List[Tuple[int, float]]:
        """Hosts whose median step time deviates by > z_threshold robust
        z-scores from the fleet median (MAD-based)."""
        meds = {h: self.host_median(h) for h in self.times}
        vals = [m for m in meds.values() if m is not None]
        if len(vals) < max(2, self.cfg.min_samples):
            return []
        fleet = statistics.median(vals)
        mad = statistics.median([abs(v - fleet) for v in vals]) or 1e-9
        out = []
        for h, m in meds.items():
            if m is None or len(self.times[h]) < self.cfg.min_samples:
                continue
            z = 0.6745 * (m - fleet) / mad
            if z > self.cfg.z_threshold:
                out.append((h, z))
                self.flag_streak[h] = self.flag_streak.get(h, 0) + 1
            else:
                self.flag_streak[h] = 0
        return sorted(out, key=lambda x: -x[1])

    # ------------------------------------------------------------------
    def should_evict(self) -> List[int]:
        return [h for h, streak in self.flag_streak.items()
                if streak >= self.cfg.evict_after]

    def rebalance(self, shards_per_host: Dict[int, int]) -> Dict[int, int]:
        """Move one data shard from each straggler to the fastest host —
        classic work-shedding mitigation (applied between steps, when the
        data pipeline can re-slice)."""
        plan = dict(shards_per_host)
        strag = [h for h, _ in self.stragglers()]
        if not strag:
            return plan
        meds = {h: self.host_median(h) or float("inf") for h in plan}
        fastest = min(plan, key=lambda h: meds.get(h, float("inf")))
        for h in strag:
            if plan.get(h, 0) > 1:
                plan[h] -= 1
                plan[fastest] = plan.get(fastest, 0) + 1
        return plan
