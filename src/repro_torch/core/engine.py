"""Shared memory-event engine: the residency and channel model that the
serving session books every decision against.

A copy of the JAX package's ``core/engine.py`` (it imports no JAX), cut to
what the serving slice uses:

  * ``DeviceLedger``  -- byte-exact device residency accounting keyed by
                         (job, storage): idempotent alloc/free, global and
                         per-job peaks, OOM counting, timeline.
  * ``DmaChannel``    -- the single host<->device transfer channel, in
                         virtual time (``acquire``/``acquire_batch``) and in
                         real time (``transfer``).
  * ``EngineTrace``   -- the ordered decision record two runs are compared
                         by.
  * ``MemoryEngine``  -- ledger + channel + profile + trace.

``JobContext``, safe points and ``AccessSequence`` belong to the training
slice and are not ported yet.  ``telemetry`` and ``recorder`` stay as
attributes that are ``None`` unless a caller sets them; this package has no
telemetry hub or trace recorder of its own yet.
"""
from __future__ import annotations

import dataclasses
import threading
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

from .plan import MachineProfile


# ----------------------------------------------------------------------
# Residency accounting
# ----------------------------------------------------------------------
class DeviceLedger:
    """Logical device-memory accounting shared by every job on the device.

    Keyed by (job_id, storage): an alloc of an already-resident storage and a
    free of an absent one are no-ops (the five-situation model makes both
    legal races), so double counting is impossible by construction.
    """

    def __init__(self, capacity_bytes: Optional[int] = None,
                 trace: Optional["EngineTrace"] = None,
                 telemetry=None):
        self.capacity = capacity_bytes
        self.used = 0
        self.peak = 0
        self.oom_events = 0
        self.lock = threading.Lock()
        # measured-telemetry plane: every residency mutation is mirrored
        # into the hub, so the executor's measured timeline and the
        # simulator's virtual one are ordered identically by construction
        self.telemetry = telemetry
        self.timeline: List[Tuple[float, int]] = []
        # per-job usage over time — what "is job j inside its slice at
        # instant t" questions (time-to-within-budget) are answered from.
        # Recorded only for VIRTUAL-time mutations (an explicit `t`, i.e.
        # bounded simulator runs); the real executor's wall-clock path
        # skips it, so long-running jobs don't grow an unread time series
        # under the ledger lock.
        self.job_timeline: Dict[str, List[Tuple[float, int]]] = {}
        self.trace = trace
        self._resident: Dict[Tuple[str, str], int] = {}
        self._job_bytes: Dict[str, int] = {}
        self._job_peak: Dict[str, int] = {}

    # -- queries -------------------------------------------------------
    def is_resident(self, job_id: str, storage: str) -> bool:
        return (job_id, storage) in self._resident

    def resident_bytes(self, job_id: str, storage: str) -> int:
        return self._resident.get((job_id, storage), 0)

    def job_bytes(self, job_id: str) -> int:
        return self._job_bytes.get(job_id, 0)

    def job_peak(self, job_id: str) -> int:
        return self._job_peak.get(job_id, 0)

    def resident_storages(self, job_id: str) -> List[str]:
        return [st for j, st in self._resident if j == job_id]

    # -- mutations -----------------------------------------------------
    def alloc(self, job_id: str, storage: str, nbytes: int,
              t: Optional[float] = None) -> bool:
        """Returns True if bytes were actually added (not already resident)."""
        with self.lock:
            key = (job_id, storage)
            if key in self._resident:
                return False
            self._resident[key] = nbytes
            self.used += nbytes
            if self.capacity is not None and self.used > self.capacity:
                self.oom_events += 1
            self.peak = max(self.peak, self.used)
            jb = self._job_bytes.get(job_id, 0) + nbytes
            self._job_bytes[job_id] = jb
            self._job_peak[job_id] = max(self._job_peak.get(job_id, 0), jb)
            now = t if t is not None else _time.perf_counter()
            self.timeline.append((now, self.used))
            if t is not None:
                self.job_timeline.setdefault(job_id, []).append((t, jb))
            if self.trace is not None:
                self.trace.record("alloc", job_id, storage)
            if self.telemetry is not None:
                self.telemetry.record_residency(job_id, storage, "alloc",
                                                jb, t)
            return True

    def free(self, job_id: str, storage: str,
             t: Optional[float] = None) -> int:
        """Returns the bytes freed (0 if the storage was not resident)."""
        with self.lock:
            key = (job_id, storage)
            if key not in self._resident:
                return 0
            nbytes = self._resident.pop(key)
            self.used -= nbytes
            jb = self._job_bytes.get(job_id, 0) - nbytes
            self._job_bytes[job_id] = jb
            now = t if t is not None else _time.perf_counter()
            self.timeline.append((now, self.used))
            if t is not None:
                self.job_timeline.setdefault(job_id, []).append((t, jb))
            if self.trace is not None:
                self.trace.record("free", job_id, storage)
            if self.telemetry is not None:
                self.telemetry.record_residency(job_id, storage, "free",
                                                jb, t)
            return nbytes

    def view(self, job_id: str,
             budget_bytes: Optional[int] = None) -> "JobLedgerView":
        """A per-job window onto this shared ledger (multi-workload
        controller: one DeviceLedger, one view per live job)."""
        return JobLedgerView(self, job_id, budget_bytes)


class JobLedgerView:
    """One job's window onto the shared ``DeviceLedger``.

    The Global Controller's BudgetArbiter assigns every live job a slice of
    the device-wide budget; this view pairs that slice with the job's live
    accounting so passes, tests and reports can ask "is job j inside its
    arbiter share?" without reaching around the ledger.  It is a *view*:
    all mutation still goes through the one shared ledger, so cross-job
    invariants (global peak, OOM counting) cannot be bypassed.
    """

    def __init__(self, ledger: DeviceLedger, job_id: str,
                 budget_bytes: Optional[int] = None):
        self.ledger = ledger
        self.job_id = job_id
        self.budget_bytes = budget_bytes

    # -- queries (job-scoped) ------------------------------------------
    @property
    def used(self) -> int:
        return self.ledger.job_bytes(self.job_id)

    @property
    def peak(self) -> int:
        return self.ledger.job_peak(self.job_id)

    def is_resident(self, job_id: str, storage: str) -> bool:
        """Residency-oracle signature (JobContext.input_action compatible);
        answers only for the owning job."""
        return job_id == self.job_id \
            and self.ledger.is_resident(job_id, storage)

    def resident_storages(self) -> List[str]:
        return self.ledger.resident_storages(self.job_id)

    # -- budget arithmetic ---------------------------------------------
    @property
    def headroom(self) -> Optional[int]:
        if self.budget_bytes is None:
            return None
        return self.budget_bytes - self.used

    @property
    def over_budget(self) -> bool:
        return self.budget_bytes is not None and self.used > self.budget_bytes

    # -- mutations (delegate; job pinned) ------------------------------
    def alloc(self, storage: str, nbytes: int,
              t: Optional[float] = None) -> bool:
        return self.ledger.alloc(self.job_id, storage, nbytes, t)

    def free(self, storage: str, t: Optional[float] = None) -> int:
        return self.ledger.free(self.job_id, storage, t)


# ----------------------------------------------------------------------
# The single host-DMA channel
# ----------------------------------------------------------------------
class DmaChannel:
    """One transfer at a time across every job (paper §IV-A).

    Virtual time (the session's clock): ``acquire(t, dur)`` books the next
    free slot FIFO and counts conflicts; ``acquire_batch`` books a
    same-direction cohort as one coalesced slot, which pays a single fixup
    latency plus a per-extra-member overhead.  Real time (the engine):
    ``transfer`` serializes actual copies behind one lock and accounts busy
    seconds.  (The reference's opt-in merging of adjacent bookings and its
    refunds serve the training planner and are not ported.)
    """

    def __init__(self):
        # virtual-time state
        self.busy_until = 0.0
        self.conflicts = 0
        self.batched_transfers = 0    # coalesced groups (2+ members)
        self.coalesced_bookings = 0   # member bookings folded into groups
        self.saved_fixup_s = 0.0      # virtual seconds of fixup elided
        # real-time state
        self.lock = threading.Lock()
        self.busy_s = 0.0
        # optional observability tap (instant events for batches)
        self.recorder = None

    def acquire(self, t: float, dur: float) -> Tuple[float, float]:
        if t < self.busy_until:
            self.conflicts += 1
            t = self.busy_until
        self.busy_until = t + dur
        return t, t + dur

    def acquire_batch(self, t: float, payload_durs, fixup: float,
                      direction: Optional[str], member_overhead: float
                      ) -> Tuple[float, float]:
        """Book one coalesced slot for an explicit same-direction cohort:
        a single ``fixup`` latency, the summed payload durations, and a
        per-extra-member overhead.  Returns the batch (start, end)."""
        durs = list(payload_durs)
        if not durs:
            return t, t
        if len(durs) == 1:
            return self.acquire(t, fixup + durs[0])
        over = float(member_overhead)
        t, end = self.acquire(t, fixup + sum(durs) + over * (len(durs) - 1))
        self.batched_transfers += 1
        self.coalesced_bookings += len(durs)
        self.saved_fixup_s += max(fixup - over, 0.0) * (len(durs) - 1)
        if self.recorder is not None:
            self.recorder.instant("dma_batch", t, direction=direction,
                                  members=len(durs))
        return t, end

    def transfer(self, fn: Callable):
        with self.lock:
            t0 = _time.perf_counter()
            out = fn()
            self.busy_s += _time.perf_counter() - t0
            return out


# ----------------------------------------------------------------------
# Decision trace (sim-vs-real parity)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class TraceRecord:
    action: str          # alloc|free|swap_out|swap_in|passive_in|recompute|release|skip
    job_id: str
    storage: str

    def key(self) -> Tuple[str, str, str]:
        return (self.action, self.job_id, self.storage)


class EngineTrace:
    """Ordered record of residency decisions; two runs of the same plan on
    the same engine semantics must produce identical traces."""

    def __init__(self):
        self.records: List[TraceRecord] = []
        self.lock = threading.Lock()
        # paused while a runtime does harness work outside the modeled
        # iteration (e.g. the executor materializing outputs to return
        # them to Python — steady state would leave them on host)
        self.paused = False

    def record(self, action: str, job_id: str, storage: str) -> None:
        if self.paused:
            return
        with self.lock:
            self.records.append(TraceRecord(action, job_id, storage))

    def keys(self) -> List[Tuple[str, str, str]]:
        return [r.key() for r in self.records]


# ----------------------------------------------------------------------
# Engine: ledger + channel + profile + trace
# ----------------------------------------------------------------------
class MemoryEngine:
    """The one memory model the serving session executes against."""

    def __init__(self, profile: Optional[MachineProfile] = None,
                 capacity_bytes: Optional[int] = None,
                 ledger: Optional[DeviceLedger] = None,
                 channel: Optional[DmaChannel] = None,
                 trace: bool = False):
        self.profile = profile or MachineProfile()
        self.trace = EngineTrace() if trace else None
        self.ledger = ledger or DeviceLedger(capacity_bytes, trace=self.trace)
        if trace and self.ledger.trace is None:
            self.ledger.trace = self.trace
        self.channel = channel or DmaChannel()
        # optional observability taps: None (the default) keeps every hook
        # at a single attribute check
        self.telemetry = None
        self.recorder = None

    def attach_recorder(self, recorder) -> None:
        """Bind a trace recorder (``span``/``counter``/``instant``) to the
        session's decode-turn tap and the DMA channel's batch events."""
        self.recorder = recorder
        self.channel.recorder = recorder
