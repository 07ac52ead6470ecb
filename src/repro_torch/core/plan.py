"""Scheduling plan & events (paper §III-A "Scheduling Plan", §III-C).

Every event is described by a tuple ``(trigger, Δtime)``: the trigger is a
tensor access (we key it by the trigger operator's index) and Δtime the delay
after the trigger's end (paper §III-D Memory Scheduler).  Absolute
``start``/``end`` instants are kept alongside for peak analysis and for the
single-channel reservation, and are recomputed whenever latencies drift.

A copy of the JAX package's ``core/plan.py`` (which imports no JAX), except
``MachineProfile``: its defaults describe one NVIDIA H100 SXM, and the
inter-chip link field waits for the distribution slice.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterable, List, Optional, Tuple

# how many times any plan rebuilt its busy-interval list (regression tests
# assert one construction per plan version, see SchedulingPlan.busy_intervals)
BUSY_REBUILDS = 0


class EventType(enum.Enum):
    SWAP_OUT = "swap_out"
    SWAP_IN = "swap_in"
    RECOMPUTE = "recompute"
    RELEASE = "release"


@dataclasses.dataclass
class ScheduleEvent:
    event_type: EventType
    tensor_id: str
    job_id: str
    trigger_op: int          # op whose completion triggers the event
    delta: float             # Δtime after trigger end
    start: float             # absolute planned start (seconds on the timeline)
    end: float               # absolute planned end
    size_bytes: int = 0
    # swap-in: the TUA this prefetch must beat; recompute: the TUA needing it
    target_op: Optional[int] = None
    # recompute: ops to re-execute
    recompute_ops: Optional[List[int]] = None
    # True for events scheduled across the iteration boundary (paper Fig 1(c))
    crosses_iteration: bool = False
    # True when the transfer goes through the quantize-on-offload path
    # (kernels/offload_quant): fewer bytes on the DMA channel, plus the
    # quantize/dequantize kernel latency (cost_model.offload_quant_latency)
    compressed: bool = False

    @property
    def duration(self) -> float:
        return self.end - self.start

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["event_type"] = self.event_type.value
        return d

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "ScheduleEvent":
        d = dict(d)
        d["event_type"] = EventType(d["event_type"])
        return ScheduleEvent(**d)  # type: ignore[arg-type]


_PLAN_UID = [0]


@dataclasses.dataclass
class SchedulingPlan:
    """Per-job plan S_j: ordered swap/recompute/release events."""

    job_id: str
    events: List[ScheduleEvent] = dataclasses.field(default_factory=list)
    # tensor -> op index after which it may be released (activity analysis +
    # planner-added early releases)
    release_after_op: Dict[str, int] = dataclasses.field(default_factory=dict)
    # metadata for reporting
    planned_peak_bytes: int = 0
    vanilla_peak_bytes: int = 0
    plan_wallclock_s: float = 0.0
    # byte budget this plan was built against: the arbiter-assigned per-job
    # slice under the Global Controller, else the device-wide budget (0 =
    # unconstrained / not recorded)
    budget_bytes: int = 0
    # observation iterations the policy charges before the plan is live
    # (Capuchin's passive-mode epoch; TENSILE/vDNN: 0)
    passive_iterations: int = 0
    # how this plan came to be, when not planned from scratch: one record
    # per incremental replan / safe-point splice, so a hot-swapped plan's
    # lineage (which op it split at, which budgets it moved between) is
    # auditable by tests and reports
    provenance: List[Dict[str, object]] = dataclasses.field(
        default_factory=list)
    # monotone edit counter: every event mutation (add / remove / truncate /
    # rebase) bumps it, so derived per-plan state — the safe-point busy
    # intervals below, the pipeline's incremental sweep caches — can key on
    # (id(plan), version) instead of rescanning the event list.  Not
    # serialized: a from_dict plan starts a fresh lineage at 0.
    version: int = dataclasses.field(default=0, init=False, repr=False,
                                     compare=False)
    # process-unique, never-recycled identity: (uid, version) names this
    # plan's event/release CONTENT (not its reporting metadata), which is
    # what lets whole-report analyze results be memoized without content
    # hashing (id() recycles addresses).  ``copy()`` shares the pair —
    # the copy is content-identical — and the first mutation of either
    # object forks it onto a fresh uid (copy-on-write), so an unchanged
    # replan copy hits the same analyze memo rows as its source.
    uid: int = dataclasses.field(default=0, init=False, repr=False,
                                 compare=False)
    _cow: bool = dataclasses.field(default=False, init=False, repr=False,
                                   compare=False)
    _busy_cache: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        _PLAN_UID[0] += 1
        self.uid = _PLAN_UID[0]

    def _bump(self) -> None:
        if self._cow:
            _PLAN_UID[0] += 1
            self.uid = _PLAN_UID[0]
            self._cow = False
        self.version += 1

    def add(self, ev: ScheduleEvent) -> None:
        self.events.append(ev)
        self._bump()

    def remove(self, ev: ScheduleEvent) -> None:
        self.events.remove(ev)
        self._bump()

    def truncate(self, n: int) -> None:
        """Drop events[n:] (a pass rolling back a failed attempt).  The
        version bump keeps busy-interval and sweep caches honest — passes
        must use this instead of ``del plan.events[n:]``."""
        if n < len(self.events):
            del self.events[n:]
            self._bump()

    def set_release(self, tid: str, op_idx: int) -> None:
        """Record an early-release point.  Release entries feed the same
        sweep caches as events, so writes go through here for the version
        bump."""
        self.release_after_op[tid] = op_idx
        self._bump()

    def busy_intervals(self, period: float) -> List[Tuple[float, float]]:
        """In-flight transfer spans of this plan, projected into
        ``[0, period)`` with the planner's PeriodicChannel wrapping.
        Cached per (version, period): ``find_safe_points`` historically
        rebuilt this list from scratch on every call even when the plan
        had not changed, which dominated preemptive-replan latency."""
        global BUSY_REBUILDS
        key = (self.version, period)
        if self._busy_cache is not None and self._busy_cache[0] == key:
            return self._busy_cache[1]
        eps = 1e-12
        busy: List[Tuple[float, float]] = []
        for ev in self.events:
            if ev.event_type not in (EventType.SWAP_OUT, EventType.SWAP_IN,
                                     EventType.RECOMPUTE):
                continue
            dur = ev.end - ev.start
            if dur <= eps:
                continue
            busy.extend((s, e)
                        for s, e in wrap_intervals(ev.start, dur, period))
        BUSY_REBUILDS += 1
        self._busy_cache = (key, busy)
        return busy

    def by_type(self, et: EventType) -> List[ScheduleEvent]:
        return [e for e in self.events if e.event_type is et]

    def swap_outs(self) -> List[ScheduleEvent]:
        return self.by_type(EventType.SWAP_OUT)

    def swap_ins(self) -> List[ScheduleEvent]:
        return self.by_type(EventType.SWAP_IN)

    def recomputes(self) -> List[ScheduleEvent]:
        return self.by_type(EventType.RECOMPUTE)

    def swapped_tensors(self) -> List[str]:
        seen, out = set(), []
        for e in self.swap_outs():
            if e.tensor_id not in seen:
                seen.add(e.tensor_id)
                out.append(e.tensor_id)
        return out

    def events_triggered_by(self, op_idx: int) -> List[ScheduleEvent]:
        return [e for e in self.events if e.trigger_op == op_idx]

    def memory_saving_bytes(self) -> int:
        return max(0, self.vanilla_peak_bytes - self.planned_peak_bytes)

    def copy(self) -> "SchedulingPlan":
        """Independent copy (events and release map are duplicated) — the
        starting point of an incremental replan, so the running plan is
        never mutated behind an executor's back."""
        p = SchedulingPlan(job_id=self.job_id)
        p.events = [
            dataclasses.replace(
                e, recompute_ops=(list(e.recompute_ops)
                                  if e.recompute_ops is not None else None))
            for e in self.events]
        p.release_after_op = dict(self.release_after_op)
        p.planned_peak_bytes = self.planned_peak_bytes
        p.vanilla_peak_bytes = self.vanilla_peak_bytes
        p.plan_wallclock_s = self.plan_wallclock_s
        p.budget_bytes = self.budget_bytes
        p.passive_iterations = self.passive_iterations
        p.provenance = [dict(r) for r in self.provenance]
        # content-identical: share (uid, version) until either side
        # mutates, so analyze memo rows built for the source also serve
        # the copy (the common no-change replan case)
        p.uid = self.uid
        p.version = self.version
        p._cow = True
        return p

    def splice(self, new_plan: "SchedulingPlan",
               at_op: int) -> "SchedulingPlan":
        """Safe-point splice: everything this plan already committed to up
        to (and including) trigger op ``at_op`` is kept verbatim — those
        events have fired or are about to under the running iteration —
        and ``new_plan`` governs every later trigger.  Release points
        follow the same rule: a release at or before the splice already
        happened under the old plan; later ones are the new plan's call.
        The result carries a provenance record naming the splice op and
        the budget move, so a hot-swapped plan is auditable."""
        out = SchedulingPlan(job_id=self.job_id)
        kept = [e for e in self.events if e.trigger_op <= at_op]
        adopted = [e for e in new_plan.events if e.trigger_op > at_op]
        out.events = kept + adopted
        out.release_after_op = {
            tid: op for tid, op in self.release_after_op.items()
            if op <= at_op}
        out.release_after_op.update(
            (tid, op) for tid, op in new_plan.release_after_op.items()
            if op > at_op)
        out.planned_peak_bytes = new_plan.planned_peak_bytes
        out.vanilla_peak_bytes = self.vanilla_peak_bytes
        out.budget_bytes = new_plan.budget_bytes
        out.passive_iterations = self.passive_iterations
        out.provenance = [dict(r) for r in self.provenance] \
            + [dict(r) for r in new_plan.provenance] \
            + [{"action": "splice", "at_op": at_op,
                "kept_events": len(kept), "adopted_events": len(adopted),
                "from_budget_bytes": self.budget_bytes,
                "to_budget_bytes": new_plan.budget_bytes}]
        return out

    def to_dict(self) -> Dict[str, object]:
        d = {
            "job_id": self.job_id,
            "events": [e.to_dict() for e in self.events],
            "release_after_op": dict(self.release_after_op),
            "planned_peak_bytes": self.planned_peak_bytes,
            "vanilla_peak_bytes": self.vanilla_peak_bytes,
            "budget_bytes": self.budget_bytes,
        }
        # only when present — the golden seed plans pin the bare shape
        if self.provenance:
            d["provenance"] = [dict(r) for r in self.provenance]
        return d

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "SchedulingPlan":
        p = SchedulingPlan(job_id=str(d["job_id"]))
        p.events = [ScheduleEvent.from_dict(e) for e in d["events"]]  # type: ignore[union-attr]
        p.release_after_op = {str(k): int(v) for k, v in d["release_after_op"].items()}  # type: ignore[union-attr]
        p.planned_peak_bytes = int(d.get("planned_peak_bytes", 0))  # type: ignore[arg-type]
        p.vanilla_peak_bytes = int(d.get("vanilla_peak_bytes", 0))  # type: ignore[arg-type]
        p.budget_bytes = int(d.get("budget_bytes", 0))  # type: ignore[arg-type]
        p.provenance = [dict(r) for r in d.get("provenance", [])]  # type: ignore[union-attr]
        return p


def wrap_intervals(start: float, duration: float,
                   period: float) -> List[List[float]]:
    """Project an absolute interval into period-wrapped pieces: an
    interval crossing the iteration boundary splits into
    ``[s, T) + [0, e-T)`` (steady state repeats every iteration).  Shared
    by the planner's PeriodicChannel bookings and the engine's safe-point
    busy-span detection so the two can never disagree about wrapping."""
    eps = 1e-9
    s = start % period
    out: List[List[float]] = []
    remaining = duration
    while remaining > eps:
        chunk = min(remaining, period - s)
        out.append([s, s + chunk])
        remaining -= chunk
        s = 0.0
    return out


class ChannelReservation:
    """The single PCIe / host-DMA channel (paper §IV-A: "there can only be one
    tensor being swapped at the same time").  Swap events from *all* jobs book
    non-overlapping intervals here.  Sorted + bisect: O(log n) queries (the
    planner issues millions on DenseNet-scale graphs)."""

    def __init__(self):
        self._intervals: List[List[float]] = []  # sorted, non-overlapping
        self._starts: List[float] = []

    def intervals(self) -> List[List[float]]:
        return [list(x) for x in self._intervals]

    def is_free(self, start: float, end: float) -> bool:
        import bisect
        i = bisect.bisect_right(self._starts, start)
        # neighbour on the left may still cover `start`
        if i > 0 and self._intervals[i - 1][1] > start + 1e-12:
            return False
        if i < len(self._intervals) and self._intervals[i][0] < end - 1e-12:
            return False
        return True

    def book(self, start: float, end: float) -> None:
        import bisect
        if not self.is_free(start, end):
            raise ValueError(f"channel interval [{start}, {end}] already booked")
        i = bisect.bisect_right(self._starts, start)
        self._intervals.insert(i, [start, end])
        self._starts.insert(i, start)

    def release(self, start: float, end: float) -> None:
        i = self._intervals.index([start, end])
        self._intervals.pop(i)
        self._starts.pop(i)

    def free_slots(self, lo: float, hi: float, duration: float) -> List[List[float]]:
        """Maximal free intervals within [lo, hi] long enough for `duration`."""
        if hi - lo < duration - 1e-12:
            return []
        slots: List[List[float]] = []
        cur = lo
        for s, e in self._intervals:
            if e <= lo or s >= hi:
                continue
            if s - cur >= duration - 1e-12:
                slots.append([cur, min(s, hi)])
            cur = max(cur, e)
            if cur >= hi:
                break
        if hi - cur >= duration - 1e-12:
            slots.append([cur, hi])
        return [x for x in slots if x[1] - x[0] >= duration - 1e-12]

    def earliest_fit(self, lo: float, hi: float, duration: float) -> Optional[float]:
        slots = self.free_slots(lo, hi, duration)
        return slots[0][0] if slots else None

    def latest_fit(self, lo: float, hi: float, duration: float) -> Optional[float]:
        slots = self.free_slots(lo, hi, duration)
        return slots[-1][1] - duration if slots else None


@dataclasses.dataclass
class MachineProfile:
    """Hardware constants used by the planner, the simulator and the
    serving session.

    Defaults describe one NVIDIA H100 SXM: the device facts come from
    NVIDIA's data sheet, the host-link figures and the quantize rate from
    the measurements ``chip_smoke.py`` makes and prints.
    """

    device_memory_bytes: int = 80 * 10 ** 9          # H100 SXM HBM3
    compute_flops: float = 989e12                    # dense bf16 tensor cores
    mem_bw: float = 3.35e12                          # HBM B/s
    # NVLink 4, per link and direction: 900 GB/s over 18 links, both
    # directions (data sheet); nothing in the planner reads it yet
    ici_bw: float = 25e9
    # host<->device copies of pinned memory, measured by chip_smoke.py on
    # an H100 80GB HBM3 (700 W limit): the slower direction's rate at
    # 256 MiB (host to device), the median host-clock time of a 512-byte
    # copy ending in a synchronisation (device to host), and the added cost
    # of each further small copy queued behind that one synchronisation
    host_link_bw: float = 51.2e9
    host_link_latency: float = 24.2e-6
    dma_batch_overhead: float = 6.6e-6
    swap_compression: float = 1.0                    # <1.0 with offload_quant
    # int8 quantize-on-offload (kernels/offload_quant): bytes-on-wire ratio
    # for a float32 tensor incl. per-block scales, (1 + 4/BLOCK) / 4
    offload_quant_ratio: float = (1.0 + 4.0 / 512.0) / 4.0
    # source bytes/s of the quantize kernel (csrc/offload_quant.cu) on a
    # 64 MiB fp32 tensor back to back, measured by chip_smoke.py on an H100
    # 80GB HBM3 (700 W limit): 1.25e12-1.43e12 across calls, the lowest
    # kept here
    offload_quant_bw: float = 1.25e12

    def swap_time(self, size_bytes: int) -> float:
        eff = size_bytes * self.swap_compression
        return self.host_link_latency + eff / self.host_link_bw

    def batched_swap_time(self, sizes) -> float:
        """One coalesced DMA batch: a single per-transfer setup, the
        summed payload at link bandwidth, plus ``dma_batch_overhead`` per
        extra member."""
        sizes = list(sizes)
        if not sizes:
            return 0.0
        eff = sum(sizes) * self.swap_compression
        return (self.host_link_latency + eff / self.host_link_bw
                + self.dma_batch_overhead * (len(sizes) - 1))

    def compressed_swap_time(self, size_bytes: int) -> float:
        """One direction of the quantize-on-offload path: the kernel reads
        the tensor and writes int8 + scales, then the DMA carries the
        compressed bytes."""
        quant = size_bytes / self.offload_quant_bw
        wire = size_bytes * self.offload_quant_ratio / self.host_link_bw
        return self.host_link_latency + quant + wire

    def transfer_time(self, size_bytes: int, compressed: bool = False) -> float:
        return (self.compressed_swap_time(size_bytes) if compressed
                else self.swap_time(size_bytes))


def merge_plans(plans: Iterable[SchedulingPlan]) -> Dict[str, SchedulingPlan]:
    return {p.job_id: p for p in plans}
