"""Sim-vs-measured drift monitor.

The parity tests pin that the simulator and executor agree *in CI, on
one job, once*.  The monitor turns that into an always-on product
signal: every comparison of a predicted quantity (sim peak, sim EOR,
modeled safe-point placement) against its measured counterpart flows
through :meth:`DriftMonitor.observe`, which

- computes relative drift per quantity,
- sets per-fingerprint drift gauges on an attached
  :class:`~repro_torch.obs.metrics.MetricsRegistry`,
- emits a WARN event on an attached
  :class:`~repro_torch.obs.events.EventLog` past ``threshold``,
- and persists the sample into the ``ExperienceStore`` drift history
  (so estimation accuracy becomes a tracked, per-workload time series,
  not a point assertion).

A copy of the JAX package's ``obs/drift.py`` (plain Python).  The
``GlobalController`` feeds it: it pins each job's admission-time peak
prediction at submit and hands over the measured peak at exit.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Dict, List, Optional, Sequence

DEFAULT_THRESHOLD = 0.15
HISTORY_LIMIT = 64


def rel_drift(predicted: float, measured: float) -> float:
    """|predicted - measured| relative to measured (0 = perfect)."""
    if measured == 0:
        return 0.0 if predicted == 0 else 1.0
    return abs(float(predicted) - float(measured)) / abs(float(measured))


def safe_point_drift(predicted: Optional[Sequence[int]],
                     measured: Optional[Sequence[int]]) -> Optional[float]:
    """Placement disagreement between two safe-point sets: 1 - Jaccard
    over op indices.  0 = same placements, 1 = disjoint."""
    if predicted is None or measured is None:
        return None
    p, m = set(predicted), set(measured)
    if not p and not m:
        return 0.0
    return 1.0 - len(p & m) / len(p | m)


@dataclasses.dataclass
class DriftSample:
    fingerprint: str
    job_id: str
    t: float
    predicted_peak: int
    measured_peak: int
    peak_drift: float
    predicted_eor: Optional[float] = None
    measured_eor: Optional[float] = None
    eor_drift: Optional[float] = None
    sp_drift: Optional[float] = None

    @property
    def worst(self) -> float:
        return max([self.peak_drift]
                   + [d for d in (self.eor_drift, self.sp_drift)
                      if d is not None])


class DriftMonitor:
    def __init__(self, threshold: float = DEFAULT_THRESHOLD,
                 events=None, metrics=None, experience=None,
                 clock=None, history_limit: int = HISTORY_LIMIT):
        self.threshold = float(threshold)
        self.events = events
        self.metrics = metrics
        self.experience = experience
        self._clock = clock or _time.time
        self.history_limit = history_limit
        self._history: Dict[str, List[DriftSample]] = {}

    # -- the one producer entry point -----------------------------------
    def observe(self, fingerprint: str, *, predicted_peak: int,
                measured_peak: int, job_id: str = "",
                predicted_eor: Optional[float] = None,
                measured_eor: Optional[float] = None,
                predicted_safe_points: Optional[Sequence[int]] = None,
                measured_safe_points: Optional[Sequence[int]] = None,
                t: Optional[float] = None) -> DriftSample:
        eor_drift = (rel_drift(predicted_eor, measured_eor)
                     if predicted_eor is not None
                     and measured_eor is not None else None)
        s = DriftSample(
            fingerprint=fingerprint, job_id=job_id,
            t=self._clock() if t is None else t,
            predicted_peak=int(predicted_peak),
            measured_peak=int(measured_peak),
            peak_drift=rel_drift(predicted_peak, measured_peak),
            predicted_eor=predicted_eor, measured_eor=measured_eor,
            eor_drift=eor_drift,
            sp_drift=safe_point_drift(predicted_safe_points,
                                      measured_safe_points))
        hist = self._history.setdefault(fingerprint, [])
        hist.append(s)
        del hist[:-self.history_limit]

        fp_label = fingerprint[:12] if fingerprint else "unknown"
        if self.metrics is not None:
            g = self.metrics.gauge(
                "tensile_drift_peak_ratio",
                "relative |sim-predicted - measured| peak bytes")
            g.set(s.peak_drift, fingerprint=fp_label)
            if s.eor_drift is not None:
                self.metrics.gauge(
                    "tensile_drift_eor_ratio",
                    "relative |sim-predicted - measured| EOR").set(
                        s.eor_drift, fingerprint=fp_label)
            if s.sp_drift is not None:
                self.metrics.gauge(
                    "tensile_drift_safe_point_ratio",
                    "1 - Jaccard of modeled vs measured safe-point "
                    "placement").set(s.sp_drift, fingerprint=fp_label)
            self.metrics.counter(
                "tensile_drift_observations_total",
                "drift comparisons performed").inc(fingerprint=fp_label)

        if self.events is not None and s.worst > self.threshold:
            self.events.warn(
                "drift",
                f"sim-vs-measured drift {s.worst:.3f} exceeds threshold "
                f"{self.threshold:.3f} for fingerprint {fp_label}",
                fingerprint=fp_label, job_id=job_id,
                peak_drift=round(s.peak_drift, 6),
                eor_drift=(None if s.eor_drift is None
                           else round(s.eor_drift, 6)),
                sp_drift=(None if s.sp_drift is None
                          else round(s.sp_drift, 6)),
                predicted_peak=s.predicted_peak,
                measured_peak=s.measured_peak)

        if self.experience is not None and fingerprint:
            try:
                self.experience.record_drift(fingerprint, s)
            except Exception as e:  # noqa: BLE001 - monitoring must not kill
                if self.events is not None:
                    self.events.warn("drift",
                                     "persisting drift history failed",
                                     fingerprint=fp_label, error=repr(e))
        return s

    # -- consumers ------------------------------------------------------
    def history(self, fingerprint: str) -> List[DriftSample]:
        return list(self._history.get(fingerprint, []))

    def last(self, fingerprint: str) -> Optional[DriftSample]:
        hist = self._history.get(fingerprint)
        return hist[-1] if hist else None

    def worst_drift(self) -> float:
        """Max worst-axis drift over the latest sample per fingerprint."""
        latest = [h[-1].worst for h in self._history.values() if h]
        return max(latest, default=0.0)

    def over_threshold(self) -> List[DriftSample]:
        return [h[-1] for h in self._history.values()
                if h and h[-1].worst > self.threshold]
