"""Shared memory-event engine: one residency/channel/event-semantics core
for BOTH the discrete-event simulator and the interpreting executor.

The paper's framework has exactly one memory model — device residency changes
at the five situations of §IV-B, transfers serialize on one host-DMA channel
(§IV-A), plan events fire as (trigger op, Δt) pairs (§III-D), and a prefetch
that misses its TUA degrades to a passive swap-in stall.  The seed
implemented that model twice (simulator.py and executor.py), which is the
main source of sim-vs-real drift.  This module owns it once:

  * ``DeviceLedger``    — byte-exact device residency accounting keyed by
                          (job, storage): idempotent alloc/free, global and
                          per-job peaks, OOM counting, timeline.
  * ``DmaChannel``      — the single host<->device transfer channel, usable
                          in *virtual time* (``acquire``: FIFO busy-until,
                          conflict counting — simulator) and in *real time*
                          (``transfer``: lock-serialized callable — executor).
  * ``JobContext``      — per-job static indices (storage aliasing, planned
                          sizes, trigger->events, last use) + the host-store
                          set, and the shared DECISION RULES: when a planned
                          event applies vs is skipped, when an operand needs
                          a passive swap-in, when a tensor auto-releases.
  * ``MemoryEngine``    — bundles ledger + channel + jobs and records an
                          ``EngineTrace`` of every decision, so a simulated
                          run and a real run of the same plan can be checked
                          for *identical* residency behaviour (the parity
                          test in tests/test_engine_parity.py).
  * ``find_safe_points``— the *safe points* of a (job, plan) pair: op
                          boundaries where no planned swap/recompute is in
                          flight on the DmaChannel and modeled residency is
                          at a local minimum.  A new plan may be hot-swapped
                          in at a safe point without tearing the iteration
                          (preemptive mid-iteration slice shrinking).

Runtimes stay thin: the simulator advances a virtual clock, the executor
moves real arrays; everything they *decide* comes from here.

A copy of the JAX package's ``core/engine.py`` (which imports no JAX),
kept in step with it; the port's tests hold the two to the same
results.
"""
from __future__ import annotations

import dataclasses
import threading
import time as _time
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from .access import AccessSequence, TensorKind
from .peak_analysis import PERSISTENT_KINDS, storage_of
from .plan import (EventType, MachineProfile, ScheduleEvent,
                   SchedulingPlan, wrap_intervals)
from .telemetry import TelemetryHub


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
                 telemetry: Optional[TelemetryHub] = None):
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

    Virtual time (simulator): ``acquire(t, dur)`` books the next free slot
    FIFO and counts cross-job conflicts.  Real time (executor): ``transfer``
    serializes actual copies behind one lock and accounts busy seconds.

    Coalescing (off by default, so default bookings are byte-identical to
    the single-transfer channel): adjacent same-direction bookings that
    land within ``coalesce_window`` of the open tail batch merge into ONE
    batched transfer — the group pays a single fixup latency plus
    ``batch_overhead_s`` per extra member instead of a full per-transfer
    setup each.  ``acquire_batch`` books an explicit cohort the same way,
    and ``transfer_batch`` is the real-time analogue: several copies under
    one channel hold (one launch on the wire).
    """

    def __init__(self, coalesce: bool = False, coalesce_window: float = 0.0,
                 batch_overhead_s: float = 0.0):
        # virtual-time state
        self.busy_until = 0.0
        self.conflicts = 0
        # most recent acquire, for best-effort refunds:
        # (busy_until before it, slot start, slot end)
        self._last_acquire: Optional[Tuple[float, float, float]] = None
        # coalescing config + the open tail batch eligible for merging:
        # (direction, batch start, batch end, member count)
        self.coalesce = bool(coalesce)
        self.coalesce_window = float(coalesce_window)
        self.batch_overhead_s = float(batch_overhead_s)
        self._tail_batch: Optional[Tuple[str, float, float, int]] = None
        self.batched_transfers = 0    # coalesced groups (2+ members)
        self.coalesced_bookings = 0   # member bookings folded into groups
        self.saved_fixup_s = 0.0      # virtual seconds of fixup elided
        # real-time state
        self.lock = threading.Lock()
        self.busy_s = 0.0
        # optional observability tap (instant events for batch merges)
        self.recorder = None

    def acquire(self, t: float, dur: float, direction: Optional[str] = None,
                fixup: float = 0.0) -> Tuple[float, float]:
        if (self.coalesce and direction is not None
                and self._tail_batch is not None):
            d, s, e, n = self._tail_batch
            if (d == direction and abs(e - self.busy_until) < 1e-12
                    and t <= e + self.coalesce_window + 1e-12):
                # merge into the open batch: pay the payload plus the
                # per-member batch overhead, not another fixup latency
                payload = max(dur - fixup, 0.0) + self.batch_overhead_s
                self.busy_until = e + payload
                self._tail_batch = (d, s, self.busy_until, n + 1)
                self._last_acquire = (e, e, self.busy_until)
                if n == 1:
                    self.batched_transfers += 1
                    self.coalesced_bookings += 1  # the member that opened it
                self.coalesced_bookings += 1
                self.saved_fixup_s += max(fixup - self.batch_overhead_s, 0.0)
                if self.recorder is not None:
                    self.recorder.instant("dma_batch_merge", e,
                                          direction=d, members=n + 1)
                return e, self.busy_until
        prev = self.busy_until
        if t < self.busy_until:
            self.conflicts += 1
            t = self.busy_until
        self.busy_until = t + dur
        self._last_acquire = (prev, t, t + dur)
        if self.coalesce:
            self._tail_batch = ((direction, t, t + dur, 1)
                                if direction is not None else None)
        return t, t + dur

    def acquire_batch(self, t: float, payload_durs, fixup: float = 0.0,
                      direction: Optional[str] = None,
                      member_overhead: Optional[float] = None
                      ) -> Tuple[float, float]:
        """Book one coalesced slot for an explicit same-direction cohort:
        a single ``fixup`` latency, the summed payload durations, and a
        per-extra-member overhead.  Returns the batch (start, end)."""
        durs = list(payload_durs)
        if not durs:
            return t, t
        over = (self.batch_overhead_s if member_overhead is None
                else float(member_overhead))
        if len(durs) == 1:
            return self.acquire(t, fixup + durs[0],
                                direction=direction, fixup=fixup)
        dur = fixup + sum(durs) + over * (len(durs) - 1)
        prev = self.busy_until
        if t < self.busy_until:
            self.conflicts += 1
            t = self.busy_until
        self.busy_until = t + dur
        self._last_acquire = (prev, t, t + dur)
        if self.coalesce:
            self._tail_batch = ((direction, t, t + dur, len(durs))
                                if direction is not None else None)
        self.batched_transfers += 1
        self.coalesced_bookings += len(durs)
        self.saved_fixup_s += max(fixup - over, 0.0) * (len(durs) - 1)
        if self.recorder is not None:
            self.recorder.instant("dma_batch", t, direction=direction,
                                  members=len(durs))
        return t, t + dur

    def try_refund(self, start: float, end: float) -> bool:
        """Best-effort cancellation of a virtual-time booking: only the
        most recent (tail) slot can be refunded — the channel is a FIFO
        scalar, earlier slots already have later bookings queued behind
        them.  Refunding the most recent acquire restores the exact
        pre-booking state; an older tail slot shrinks to its start.  Used
        when an incremental replan cancels a swap-in that was booked but
        has not started at the safe point."""
        if self._last_acquire is not None:
            prev, s, e = self._last_acquire
            if abs(s - start) < 1e-12 and abs(e - end) < 1e-12 \
                    and abs(self.busy_until - end) < 1e-12:
                self.busy_until = prev
                self._last_acquire = None
                return True
        if abs(self.busy_until - end) < 1e-12 and start < end:
            self.busy_until = start
            return True
        return False

    def transfer(self, fn: Callable):
        with self.lock:
            t0 = _time.perf_counter()
            out = fn()
            self.busy_s += _time.perf_counter() - t0
            return out

    def transfer_batch(self, fns) -> list:
        """Run several copies under ONE channel hold — the real-time form
        of a coalesced batch: a single acquisition of the wire covers the
        whole cohort instead of one lock round-trip per member."""
        with self.lock:
            t0 = _time.perf_counter()
            out = [fn() for fn in fns]
            self.busy_s += _time.perf_counter() - t0
            if len(out) > 1:
                self.batched_transfers += 1
                self.coalesced_bookings += len(out)
            return out


class ResidencyView:
    """Minimal residency oracle the decision rules consult.  DeviceLedger is
    one (the simulator's); the executor supplies a view over its own value
    store, because under the multi-workload controller the global ledger
    outlives a single iteration's executor instance."""

    def __init__(self, store):
        self._store = store

    def is_resident(self, job_id: str, storage: str) -> bool:
        return storage in self._store


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
# Per-job context: static indices + host store + decision rules
# ----------------------------------------------------------------------
# what an operator must do about a not-yet-resident input
INPUT_RESIDENT = "resident"          # nothing to do
INPUT_AWAIT_PREFETCH = "await"       # planned swap-in in flight: stall on it
INPUT_PASSIVE_SWAP_IN = "passive"    # host copy exists: blocking swap-in
INPUT_RECOMPUTE = "recompute"        # regenerate from the producer op


class JobContext:
    """Everything the engine knows statically about one job's plan, plus the
    host-store set that evolves as the plan runs."""

    def __init__(self, seq: AccessSequence,
                 plan: Optional[SchedulingPlan] = None,
                 offset: float = 0.0):
        self.seq = seq
        self.plan = plan
        self.offset = offset
        self.job_id = seq.job_id

        # storage aliasing + planned byte sizes (max over aliases)
        self.storage: Dict[str, str] = {}
        self.sizes: Dict[str, int] = {}
        for t in seq.tensors.values():
            st = storage_of(t)
            self.storage[t.tid] = st
            self.sizes[st] = max(self.sizes.get(st, 0), t.size_bytes)

        # last use per *storage* (max over aliases; §IV-B situation 5)
        self.last_use: Dict[str, int] = {}
        for tid, idx in seq.activity_analysis().items():
            st = self.storage.get(tid, tid)
            self.last_use[st] = max(self.last_use.get(st, -1), idx)

        # storages that persist across iterations / must not auto-release
        self.protected: Set[str] = set()
        for t in seq.tensors.values():
            if (t.kind in PERSISTENT_KINDS or t.updates is not None
                    or t.kind is TensorKind.OUTPUT):
                self.protected.add(storage_of(t))

        # plan indices
        self.by_trigger: Dict[int, List[ScheduleEvent]] = {}
        self.recompute_for: Dict[str, ScheduleEvent] = {}
        self.set_plan(plan)

        # host-store membership (the data lives there; values are runtime-
        # specific — the simulator keeps none, the executor keeps arrays)
        self.host: Set[str] = set()
        # storages whose host copy went through the quantize-on-offload
        # path — fetching them back pays the compressed transfer time
        self.host_compressed: Set[str] = set()

    def set_plan(self, plan: Optional[SchedulingPlan]) -> None:
        """(Re)bind the plan and rebuild its trigger indices.  Called at
        construction and at a safe-point hot-swap: the runtime splices a
        new plan mid-iteration, and because the new plan's events at or
        before the splice op are identical to the old one's, every decision
        already taken stays valid — only future triggers change.  The host
        store and sizes are state of the *job*, not the plan, and carry
        over untouched."""
        self.plan = plan
        self.by_trigger = {}
        self.recompute_for = {}
        if plan:
            for ev in plan.events:
                self.by_trigger.setdefault(ev.trigger_op, []).append(ev)
                if ev.event_type is EventType.RECOMPUTE:
                    self.recompute_for[self.st(ev.tensor_id)] = ev

    # -- helpers -------------------------------------------------------
    def st(self, tid: str) -> str:
        return self.storage.get(tid, tid)

    def size_of(self, tid_or_storage: str) -> int:
        st = self.st(tid_or_storage)
        return self.sizes.get(st, 0)

    def events_triggered_by(self, op_idx: int) -> List[ScheduleEvent]:
        return self.by_trigger.get(op_idx, [])

    # -- decision rules (THE shared semantics) -------------------------
    def input_action(self, residency, tid: str,
                     prefetch_inflight: bool = False) -> str:
        """What must happen before an operator may read `tid` (paper
        Executor semantics: prefetch-wait, else passive swap-in, else
        recompute from the producer).  `residency` is any object with
        ``is_resident(job_id, storage)`` — the DeviceLedger or an
        executor's ResidencyView."""
        st = self.st(tid)
        if residency.is_resident(self.job_id, st):
            return INPUT_RESIDENT
        if prefetch_inflight:
            return INPUT_AWAIT_PREFETCH
        if st in self.host:
            return INPUT_PASSIVE_SWAP_IN
        return INPUT_RECOMPUTE

    def should_auto_release(self, tid: str, op_idx: int,
                            free_at_last_use: bool = True) -> bool:
        """Situation 5: free after the storage's last access — unless the
        plan overrides the release point, the tensor persists across
        iterations (params/opt-state/updated aliases), or it is a job
        output."""
        st = self.st(tid)
        if self.plan is not None:
            rel_op = self.plan.release_after_op.get(tid)
            if rel_op is not None:
                return rel_op == op_idx
        if not free_at_last_use:
            return False
        return self.last_use.get(st) == op_idx and st not in self.protected

    def event_applies(self, residency, ev: ScheduleEvent) -> bool:
        """Skip rules shared by sim and executor: a swap-out needs a device
        copy; a swap-in needs a host copy and no device copy (iteration-0
        cold start of a cross-iteration plan has neither); a planned release
        is only safe when a host copy or a recompute event can restore the
        value; a recompute only fires when the value is absent."""
        st = self.st(ev.tensor_id)
        resident = residency.is_resident(self.job_id, st)
        if ev.event_type is EventType.SWAP_OUT:
            return resident
        if ev.event_type is EventType.SWAP_IN:
            return (not resident) and st in self.host
        if ev.event_type is EventType.RELEASE:
            return resident and (st in self.host or st in self.recompute_for)
        if ev.event_type is EventType.RECOMPUTE:
            return not resident
        return False


# ----------------------------------------------------------------------
# Safe points: where a plan may be hot-swapped mid-iteration
# ----------------------------------------------------------------------
@dataclasses.dataclass
class SafePoint:
    """An op boundary where a job's plan can be spliced without tearing
    the iteration: no planned transfer or recompute spans the instant, and
    modeled residency is at a local minimum (so eager swap-outs scheduled
    from here act on a quiescent footprint)."""

    op_idx: int          # boundary right after this operator completes
    time: float          # job-local instant (seq.op_end[op_idx])
    resident_bytes: int  # modeled device residency at the boundary


def _measured_safe_points(seq: AccessSequence, telemetry: TelemetryHub,
                          min_iterations: int) -> Optional[List[SafePoint]]:
    """Safe points from the MEASURED residency timeline: op boundaries
    that, in each of the last ``min_iterations`` completed iterations,
    were quiescent (no recorded transfer in flight across the measured
    completion instant) and at a non-strict local minimum of the measured
    per-boundary residency.  Returns None when fewer than
    ``min_iterations`` instrumented iterations exist — the caller falls
    back to the modeled ledger (cold start, paper §IV-C blending)."""
    job_id = seq.job_id
    n = len(seq.operators)
    if n <= 1:
        return []
    done = telemetry.iterations(job_id)
    if done < min_iterations:
        return None
    common: Optional[set] = None
    res_sum: Dict[int, int] = {}
    for it in range(done - min_iterations, done):
        resident = telemetry.measured_boundary_residency(job_id, it, n)
        quiescent = telemetry.quiescent_boundaries(job_id, it, n)
        if resident is None or quiescent is None:
            return None                      # iteration not instrumented
        ok = set()
        qset = set(quiescent)
        for k in range(n - 1):               # final op == iteration boundary
            if k not in qset:
                continue
            left = resident[k - 1] if k > 0 else resident[k]
            right = resident[k + 1]
            if resident[k] <= left and resident[k] <= right:
                ok.add(k)
        common = ok if common is None else (common & ok)
        for k in ok:
            res_sum[k] = res_sum.get(k, 0) + resident[k]
    if not common:
        return []
    return [SafePoint(op_idx=k, time=seq.op_end[k],
                      resident_bytes=res_sum[k] // min_iterations)
            for k in sorted(common)]


def find_safe_points(seq: AccessSequence,
                     plan: Optional[SchedulingPlan] = None,
                     free_at_last_use: bool = True,
                     source: str = "modeled",
                     telemetry: Optional[TelemetryHub] = None,
                     min_iterations: int = 2) -> List[SafePoint]:
    """Safe points of one (job, plan) pair, in op order.

    A boundary after op k qualifies when (1) no swap/recompute event of the
    plan is in flight across ``op_end[k]`` — a splice must not orphan a
    transfer already booked on the DmaChannel — and (2) the residency the
    plan models at that instant is a local minimum (non-strict, so flat
    plateaus qualify).  The final op is excluded: that boundary is the
    iteration boundary, which is the non-preemptive case.  Cross-iteration
    events are wrapped modulo the iteration period, mirroring the planner's
    PeriodicChannel bookings.

    ``source="measured"`` detects the same two conditions from the
    TelemetryHub's measured records instead of the modeled ledger; below
    ``min_iterations`` of instrumented iterations (or with no hub at all)
    it falls back to the modeled path — the paper's §IV-C cold-start
    blending applied to safe-point detection.

    The modeled path is a vectorized numpy sweep over the job's SoA event
    buffers (shared with ``peak_analysis.analyze``); the busy-interval
    list is cached on the plan per ``SchedulingPlan.version``.
    ``_reference_safe_points`` keeps the original per-event scan for the
    equivalence tests.
    """
    if source == "measured" and telemetry is not None:
        measured = _measured_safe_points(seq, telemetry, min_iterations)
        if measured is not None:
            return measured

    from .peak_analysis import _effective_mask, _seq_arrays

    eps = 1e-12
    n = len(seq.operators)
    if n <= 1:
        return []
    T = max(seq.iteration_time, eps)

    # (1) in-flight intervals of the plan, projected into [0, T) with the
    # same wrapping the planner's PeriodicChannel books with (cached on
    # the plan; rebuilt only when plan.version moves)
    busy = plan.busy_intervals(T) if plan is not None else []

    # (2) modeled residency at every op boundary: effective-event cumsum
    # (idempotent alloc/free — exactly the ledger semantics), then one
    # searchsorted per boundary instead of the per-event scan
    t, o, d, k_ids, _rel, _base = _seq_arrays(seq, plan, free_at_last_use)
    op_end = np.asarray(seq.op_end[:n], dtype=np.float64)
    if len(t):
        eff = _effective_mask(k_ids, d)
        mem = np.cumsum(np.where(eff, d, 0))
        cnt = np.searchsorted(t, op_end + eps, side="right")
        resident = np.where(cnt > 0, mem[np.maximum(cnt - 1, 0)], 0)
    else:
        resident = np.zeros(n, dtype=np.int64)

    # (3) local-minimum + not-busy filter over boundaries 0..n-2 (the
    # final op is the iteration boundary — the non-preemptive case)
    r = resident
    left = np.empty(n - 1, dtype=r.dtype)
    left[0] = r[0]
    left[1:] = r[:-2] if n > 2 else r[:0]
    ok = (r[:-1] <= left) & (r[:-1] <= r[1:])
    if busy:
        # covered iff some interval has s < t_k - eps AND e > t_k + eps:
        # sort by start, prefix-max of ends, one searchsorted per boundary
        bs = np.asarray([s for s, _ in busy], dtype=np.float64)
        be = np.asarray([e for _, e in busy], dtype=np.float64)
        srt = np.argsort(bs, kind="stable")
        bs, be = bs[srt], be[srt]
        pmax_e = np.maximum.accumulate(be)
        tk = op_end[:n - 1]
        ns = np.searchsorted(bs, tk - eps, side="left")
        covered = (ns > 0) & (pmax_e[np.maximum(ns - 1, 0)] > tk + eps)
        ok &= ~covered
    return [SafePoint(op_idx=int(kk), time=float(op_end[kk]),
                      resident_bytes=int(r[kk]))
            for kk in np.flatnonzero(ok)]


def _reference_safe_points(seq: AccessSequence,
                           plan: Optional[SchedulingPlan] = None,
                           free_at_last_use: bool = True) -> List[SafePoint]:
    """The original per-event modeled safe-point scan, kept verbatim as
    the semantic reference for the vectorized path above (equivalence
    tests assert identical SafePoint lists).  Not on any hot path."""
    from .peak_analysis import build_events

    eps = 1e-12
    n = len(seq.operators)
    if n <= 1:
        return []
    T = max(seq.iteration_time, eps)

    busy: List[Tuple[float, float]] = []
    if plan is not None:
        for ev in plan.events:
            if ev.event_type not in (EventType.SWAP_OUT, EventType.SWAP_IN,
                                     EventType.RECOMPUTE):
                continue
            dur = ev.end - ev.start
            if dur <= eps:
                continue
            busy.extend((s, e) for s, e in wrap_intervals(ev.start, dur, T))

    events = sorted(build_events(seq, plan, free_at_last_use=free_at_last_use),
                    key=lambda e: (e.time, e.order))
    resident = [0] * n
    live: Dict[str, int] = {}
    mem = 0
    ei = 0
    for k in range(n):
        t_k = seq.op_end[k]
        while ei < len(events) and events[ei].time <= t_k + eps:
            e = events[ei]
            ei += 1
            if e.delta > 0:
                if e.storage not in live:
                    live[e.storage] = e.delta
                    mem += e.delta
            elif e.storage in live:
                mem -= live.pop(e.storage)
        resident[k] = mem

    out: List[SafePoint] = []
    for k in range(n - 1):
        t_k = seq.op_end[k]
        if any(s < t_k - eps and t_k < e - eps for s, e in busy):
            continue
        left = resident[k - 1] if k > 0 else resident[k]
        right = resident[k + 1]
        if resident[k] <= left and resident[k] <= right:
            out.append(SafePoint(op_idx=k, time=t_k,
                                 resident_bytes=resident[k]))
    return out


# ----------------------------------------------------------------------
# Engine: ledger + channel + jobs + event timing
# ----------------------------------------------------------------------
def event_duration(profile: MachineProfile, ev: ScheduleEvent) -> float:
    """Planned transfer duration of a swap event.  The planner stamps
    ``start``/``end`` from the cost model (incl. the quantize-on-offload
    latency for compressed events); fall back to the profile for
    hand-constructed events."""
    if ev.end > ev.start:
        return ev.end - ev.start
    return profile.transfer_time(ev.size_bytes, compressed=ev.compressed)


class MemoryEngine:
    """The one memory model both runtimes execute against."""

    def __init__(self, profile: Optional[MachineProfile] = None,
                 capacity_bytes: Optional[int] = None,
                 ledger: Optional[DeviceLedger] = None,
                 channel: Optional[DmaChannel] = None,
                 trace: bool = False,
                 telemetry: Optional[TelemetryHub] = None):
        self.profile = profile or MachineProfile()
        self.trace = EngineTrace() if trace else None
        self.ledger = ledger or DeviceLedger(capacity_bytes, trace=self.trace)
        if trace and self.ledger.trace is None:
            self.ledger.trace = self.trace
        self.channel = channel or DmaChannel()
        self.jobs: Dict[str, JobContext] = {}
        self.telemetry: Optional[TelemetryHub] = None
        # optional observability tap: None (the default) keeps every
        # hook at a single attribute check
        self.recorder = None
        if telemetry is not None:
            self.attach_telemetry(telemetry)

    def attach_telemetry(self, hub: TelemetryHub) -> None:
        """Bind the measured-telemetry hub: residency mutations on the
        ledger mirror into it from here on (both runtimes emit through
        this single point, so record ordering stays parity-testable)."""
        self.telemetry = hub
        if self.ledger.telemetry is None:
            self.ledger.telemetry = hub
        if self.recorder is not None and hub._recorder is None:
            hub.attach_recorder(self.recorder)

    def attach_recorder(self, recorder) -> None:
        """Bind a trace recorder to every tap this engine owns: the
        telemetry hub's publish point, the DMA channel's batch events,
        and the runtimes' hot-swap instants (which read
        ``engine.recorder``).  Attach order vs ``attach_telemetry`` does
        not matter — whichever lands second propagates."""
        self.recorder = recorder
        self.channel.recorder = recorder
        if self.telemetry is not None and self.telemetry._recorder is None:
            self.telemetry.attach_recorder(recorder)

    def add_job(self, seq: AccessSequence,
                plan: Optional[SchedulingPlan] = None,
                offset: float = 0.0) -> JobContext:
        job = JobContext(seq, plan, offset)
        self.jobs[job.job_id] = job
        return job

    def job(self, job_id: str) -> JobContext:
        return self.jobs[job_id]

    # -- traced wrappers (decision + accounting in one place) ----------
    def record(self, action: str, job: JobContext, storage: str) -> None:
        if self.trace is not None:
            self.trace.record(action, job.job_id, storage)

    def complete_swap_out(self, job: JobContext, storage: str,
                          t: Optional[float] = None,
                          compressed: bool = False) -> int:
        """Eviction lands: host copy exists, device copy freed."""
        job.host.add(storage)
        if compressed:
            job.host_compressed.add(storage)
        else:
            job.host_compressed.discard(storage)
        self.record("swap_out", job, storage)
        return self.ledger.free(job.job_id, storage, t)

    def complete_swap_in(self, job: JobContext, storage: str,
                         t: Optional[float] = None,
                         passive: bool = False) -> bool:
        """Prefetch (or passive fetch) lands: device copy restored.  The
        host copy is retained — later planned release+swap-in pairs reuse
        it (paper: 'swap-in the rest of accesses greedily')."""
        self.record("passive_in" if passive else "swap_in", job, storage)
        return self.ledger.alloc(job.job_id, storage,
                                 job.sizes.get(storage, 0), t)

    def event_duration(self, ev: ScheduleEvent) -> float:
        return event_duration(self.profile, ev)
