"""Priority admission queue gated on predicted peak memory.

The queue is a pure data structure — no threads, no clocks — so the live
daemon (real time) and the scenario suite's virtual-time overload replay
(``benchmarks/scenarios.py``) exercise the *same* admission policy.

Policy: jobs wait in ``(-priority, arrival)`` order.  A job is admitted when
its predicted peak fits the unreserved capacity; the scan greedily backfills
past a blocked job so small jobs are not starved behind a large head-of-line
job, but a blocked higher-priority job keeps its place for the next pass.
Admission *reserves* the predicted peak; the reservation is refined to the
measured peak after the job's first profiled iteration (shrinking a
conservative cost-model bound frees headroom and can admit waiting jobs) and
released when the job finishes.

Invariant (the CI admission contract): the sum of live reservations never
exceeds capacity.  ``max_reserved_bytes`` tracks the high-water mark so the
contract is auditable after a run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

PREDICTED_SOURCE_EXPERIENCE = "experience"
PREDICTED_SOURCE_COST_MODEL = "cost-model"
PREDICTED_SOURCE_MEASURED = "measured"


@dataclasses.dataclass
class QueuedJob:
    job_id: str
    predicted_peak_bytes: int
    priority: float = 1.0
    source: str = PREDICTED_SOURCE_COST_MODEL
    enqueued_at: float = 0.0
    seq_no: int = 0

    def sort_key(self):
        return (-self.priority, self.seq_no)


class AdmissionQueue:
    """Admission by predicted peak against a fixed byte capacity."""

    def __init__(self, capacity_bytes: int):
        if capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be > 0")
        self.capacity_bytes = int(capacity_bytes)
        self._waiting: List[QueuedJob] = []
        self._reservations: Dict[str, int] = {}
        self._sources: Dict[str, str] = {}
        self._seq = 0
        self.max_reserved_bytes = 0
        # (job_id, reserved_at_admission) in admission order, for audits.
        self.admission_log: List[tuple] = []

    # -- waiting set ---------------------------------------------------------

    def push(self, job_id: str, predicted_peak_bytes: int,
             priority: float = 1.0,
             source: str = PREDICTED_SOURCE_COST_MODEL,
             enqueued_at: float = 0.0) -> QueuedJob:
        """Enqueue a job.  Raises ``ValueError`` if it can *never* fit —
        the caller records it REJECTED instead of letting it starve."""
        predicted = int(predicted_peak_bytes)
        if predicted > self.capacity_bytes:
            raise ValueError(
                f"job {job_id!r}: predicted peak {predicted} exceeds device "
                f"capacity {self.capacity_bytes} — never admissible"
            )
        if any(q.job_id == job_id for q in self._waiting) \
                or job_id in self._reservations:
            raise ValueError(f"job {job_id!r} already queued or admitted")
        self._seq += 1
        job = QueuedJob(job_id=job_id, predicted_peak_bytes=max(predicted, 0),
                        priority=priority, source=source,
                        enqueued_at=enqueued_at, seq_no=self._seq)
        self._waiting.append(job)
        self._waiting.sort(key=QueuedJob.sort_key)
        return job

    def remove(self, job_id: str) -> bool:
        """Drop a still-waiting job (cancellation)."""
        n = len(self._waiting)
        self._waiting = [q for q in self._waiting if q.job_id != job_id]
        return len(self._waiting) < n

    @property
    def waiting(self) -> List[QueuedJob]:
        return list(self._waiting)

    def __len__(self) -> int:
        return len(self._waiting)

    # -- reservation ledger --------------------------------------------------

    @property
    def reserved_bytes(self) -> int:
        return sum(self._reservations.values())

    @property
    def free_bytes(self) -> int:
        return self.capacity_bytes - self.reserved_bytes

    @property
    def reservations(self) -> Dict[str, int]:
        return dict(self._reservations)

    def refine(self, job_id: str, measured_peak_bytes: int) -> Optional[int]:
        """Replace an admitted job's reservation with its measured peak
        (first profiled iteration).  Returns the new reservation, or None
        if the job holds no reservation.  Growing past capacity is clamped —
        the plan certifies the job under its budget; the clamp only keeps
        the ledger's invariant intact under measurement noise."""
        if job_id not in self._reservations:
            return None
        old = self._reservations[job_id]
        new = max(1, min(int(measured_peak_bytes),
                         old + self.free_bytes))  # never exceed capacity
        self._reservations[job_id] = new
        self._sources[job_id] = PREDICTED_SOURCE_MEASURED
        self.max_reserved_bytes = max(self.max_reserved_bytes,
                                      self.reserved_bytes)
        return new

    def release(self, job_id: str) -> Optional[int]:
        """Free a finished (or failed) job's reservation."""
        self._sources.pop(job_id, None)
        return self._reservations.pop(job_id, None)

    def source_of(self, job_id: str) -> Optional[str]:
        return self._sources.get(job_id)

    # -- admission -----------------------------------------------------------

    def pop_admissible(self, now: float = 0.0) -> List[QueuedJob]:
        """Admit every waiting job that fits the unreserved capacity.

        Scans in priority order with greedy backfill: a blocked job is
        skipped (it keeps its place), later smaller jobs may still be
        admitted.  Reservations are taken immediately, so the returned
        admitted set is capacity-sound by construction.
        """
        admitted: List[QueuedJob] = []
        still_waiting: List[QueuedJob] = []
        for job in self._waiting:
            if job.predicted_peak_bytes <= self.free_bytes:
                self._reservations[job.job_id] = job.predicted_peak_bytes
                self._sources[job.job_id] = job.source
                self.max_reserved_bytes = max(self.max_reserved_bytes,
                                              self.reserved_bytes)
                self.admission_log.append((job.job_id,
                                           job.predicted_peak_bytes, now))
                admitted.append(job)
            else:
                still_waiting.append(job)
        self._waiting = still_waiting
        return admitted
