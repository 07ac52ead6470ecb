"""Swap Event scheduling (paper §IV-A, Algorithm 1).

Greedy: pick the largest tensor among those causing the memory peak (MPT),
compute the feasible time regions of its Swap-Out / Swap-In events under the
three constraints of §IV-A —

  1. swap-out starts after the tensor's TGA and ends before the peak instant;
     swap-in starts after the swap-out ends and finishes before the next TUA;
  2. the single host-DMA (PCIe) channel carries one transfer at a time;
  3. a swap event must not overlap the tensor's own accesses —

and place the swap-out as early and the swap-in as late as possible.  Updated
parameters (Opt phase) are scheduled **across the iteration boundary**: their
swap-in targets the first TUA of the aliased parameter in the *next*
iteration (paper Fig. 1(c)).  Because steady-state execution is periodic with
the iteration period T, the planner works in wrapped time modulo T with a
periodic channel reservation.

A copy of the JAX package's ``core/swap_planner.py`` (which imports no JAX),
kept in step with it; the port's tests hold the two to the same
results.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .access import AccessSequence, TensorKind
from .peak_analysis import PERSISTENT_KINDS, PeakReport, storage_of
from .plan import (ChannelReservation, EventType, MachineProfile,
                   ScheduleEvent, SchedulingPlan, wrap_intervals)

EPS = 1e-9


class PeriodicChannel:
    """Single-transfer channel with period-T wrapped bookings.

    An interval that crosses the iteration boundary is split into
    ``[s, T) + [0, e-T)``; in steady state every iteration repeats the same
    occupancy, so one wrapped period describes the channel fully.
    """

    def __init__(self, period: float):
        self.period = float(period)
        self._res = ChannelReservation()

    def _pieces(self, start: float, duration: float) -> List[List[float]]:
        return wrap_intervals(start, duration, self.period)

    def is_free(self, start: float, duration: float) -> bool:
        return all(self._res.is_free(s, e) for s, e in self._pieces(start, duration))

    def book(self, start: float, duration: float) -> None:
        for s, e in self._pieces(start, duration):
            self._res.book(s, e)

    def release(self, start: float, duration: float) -> None:
        for s, e in self._pieces(start, duration):
            self._res.release(s, e)

    def earliest_fit(self, lo: float, hi: float, duration: float,
                     blocked: Sequence[Tuple[float, float]] = ()) -> Optional[float]:
        """Earliest start in [lo, hi - duration] whose transfer fits the
        channel and avoids `blocked` (absolute, unwrapped) intervals."""
        return self._scan(lo, hi, duration, blocked, latest=False)

    def latest_fit(self, lo: float, hi: float, duration: float,
                   blocked: Sequence[Tuple[float, float]] = ()) -> Optional[float]:
        return self._scan(lo, hi, duration, blocked, latest=True)

    def _scan(self, lo: float, hi: float, duration: float,
              blocked: Sequence[Tuple[float, float]], latest: bool) -> Optional[float]:
        if hi - lo < duration - EPS:
            return None
        # candidate start points: region edges, ends of channel bookings and
        # blocked intervals (projected into every period copy inside [lo, hi]);
        # scanned in preference order with early exit (the planner issues
        # millions of fit queries on large graphs)
        cands = {lo, hi - duration}
        T = self.period
        k0 = int(lo // T)
        k1 = int(hi // T) + 1
        for s, e in self._res.intervals():
            for k in range(k0, k1 + 1):
                cands.add(k * T + e)          # start right after a booking
                cands.add(k * T + s - duration)  # end right before one
        for s, e in blocked:
            cands.add(e)
            cands.add(s - duration)
        ordered = sorted(cands, reverse=latest)
        for c in ordered:
            if not (lo - EPS <= c and c + duration <= hi + EPS):
                continue
            if self.is_free(c, duration) \
                    and not _overlaps_any(c, c + duration, blocked):
                return c
        return None


def _overlaps_any(s: float, e: float, blocked: Sequence[Tuple[float, float]]) -> bool:
    return any(bs < e - EPS and s < be - EPS for bs, be in blocked)


@dataclasses.dataclass
class SwapAttempt:
    succeeded: bool
    succeed_swap_out: bool
    have_first_access: bool
    events: List[ScheduleEvent] = dataclasses.field(default_factory=list)


class SwapPlanner:
    """Per-job Algorithm 1 state.  The cross-job conflict is mitigated by the
    max-swapping-ratio limit (paper §IV-A), not by cross-job channel
    coordination — jobs run asynchronously so event order across jobs is not
    controllable."""

    def __init__(self, seq: AccessSequence, plan: SchedulingPlan,
                 profile: MachineProfile,
                 max_swap_ratio: float = 1.0,
                 cross_iteration: bool = True,
                 compressed: bool = False,
                 max_tensor_bytes: Optional[int] = None,
                 not_before: float = 0.0,
                 telemetry=None,
                 experience=None):
        self.seq = seq
        self.plan = plan
        self.profile = profile
        self.max_swap_ratio = max_swap_ratio
        # measured-telemetry plane: when a hub with enough transfer
        # samples is attached, swap windows are sized from the MEASURED
        # DMA bandwidth instead of the profile constant — `not_before`
        # feasibility and planned-vs-real overlap are then judged against
        # what the channel actually sustains.  None (the default) keeps
        # the modeled constants, so plans stay byte-reproducible.
        self.telemetry = telemetry
        # experience plane: between a cold start and the first live
        # transfer samples, windows are sized from the bandwidth a PRIOR
        # run measured and persisted (ExperienceStore) — live telemetry,
        # once present, always wins over stored experience.  Resolved
        # ONCE here: the stored value is static for the process and
        # _swap_time sits inside the Alg.-3 convergence hot loop (a
        # per-call store read would hit disk thousands of times)
        self.experience = experience
        self._experience_bw: Optional[float] = None
        if experience is not None:
            try:
                self._experience_bw = experience.bandwidth(
                    compressed=compressed)
            except Exception:   # noqa: BLE001 - corrupt store: modeled path
                self._experience_bw = None
        # incremental replans (safe-point hot-swap) must not schedule new
        # events before the splice instant — the past already executed
        self.not_before = not_before
        # False restricts scheduling to within one iteration (no Opt-phase
        # updated-param events — the Capuchin limitation TENSILE lifts)
        self.cross_iteration = cross_iteration
        # compressed=True routes transfers through the quantize-on-offload
        # path: shorter channel bookings (CompressedOffloadPass); an optional
        # size cap keeps quantization error confined to small tensors
        self.compressed = compressed
        self.max_tensor_bytes = max_tensor_bytes
        self.channel = PeriodicChannel(max(seq.iteration_time, EPS))
        self.swapped: set = set(plan.swapped_tensors())
        # structural inputs (swappable count + storage -> candidate tensor
        # ids, updated-param aliases first): with an ExperienceStore
        # attached these come from its per-fingerprint JobPassState memo —
        # identical values, skipping the O(tensors) reconstruction every
        # replan pays (plan_one_swap runs once per greedy iteration over
        # thousands of MPT entries; a per-entry full-tensor scan is
        # quadratic)
        ps = None
        if experience is not None:
            try:
                ps = experience.pass_state(seq)
            except Exception:   # noqa: BLE001 - corrupt store: cold path
                ps = None
        if ps is None:
            from .pass_state import default_pass_state
            ps = default_pass_state(seq)
        self._swappable_total = ps.swappable_total
        self.alias_candidates: Dict[str, List[str]] = ps.alias_candidates
        # re-book existing events (planner may be re-run after latency drift)
        for ev in plan.events:
            if ev.event_type in (EventType.SWAP_OUT, EventType.SWAP_IN):
                try:
                    self.channel.book(ev.start, ev.duration)
                except ValueError:
                    pass

    # ------------------------------------------------------------------
    def _swap_time(self, size_bytes: int) -> float:
        if self.telemetry is not None:
            bw = self.telemetry.measured_bandwidth(
                compressed=self.compressed)
            if bw:
                # measured effective bandwidth for the size-dependent
                # term; the per-transfer setup cost stays the profile's
                return self.profile.host_link_latency + size_bytes / bw
        if self._experience_bw:
            return self.profile.host_link_latency \
                + size_bytes / self._experience_bw
        return self.profile.transfer_time(size_bytes,
                                          compressed=self.compressed)

    # ------------------------------------------------------------------
    def swap_ratio(self) -> float:
        return len(self.swapped) / self._swappable_total

    def ratio_allows(self) -> bool:
        return self.swap_ratio() < self.max_swap_ratio - EPS

    # ------------------------------------------------------------------
    def _own_access_blocks(self, tid: str) -> List[Tuple[float, float]]:
        """Constraint 3: swap events cannot overlap the tensor's accesses."""
        return [(a.time, a.end_time) for a in self.seq.tensor_accesses(tid)
                if a.end_time > a.time]

    def _trigger_for(self, start: float) -> Tuple[int, float]:
        """Map an absolute instant to (trigger op, Δtime) — the plan's native
        event encoding (paper §III-D)."""
        t = start % max(self.seq.iteration_time, EPS)
        trig = -1
        for i, end in enumerate(self.seq.op_end):
            if end <= t + EPS:
                trig = i
            else:
                break
        base = self.seq.op_end[trig] if trig >= 0 else 0.0
        return trig, t - base

    def _mk_event(self, et: EventType, tid: str, start: float, dur: float,
                  target_op: Optional[int] = None,
                  crosses: bool = False) -> ScheduleEvent:
        trig, delta = self._trigger_for(start)
        spec = self.seq.tensors[tid]
        return ScheduleEvent(
            event_type=et, tensor_id=tid, job_id=self.seq.job_id,
            trigger_op=trig, delta=delta, start=start, end=start + dur,
            size_bytes=spec.size_bytes, target_op=target_op,
            crosses_iteration=crosses, compressed=self.compressed)

    # ------------------------------------------------------------------
    def scheduling_swap(self, tid: str, latest_time: float) -> SwapAttempt:
        """Paper Algorithm 1 `scheduling_swap` for one tensor."""
        seq, prof = self.seq, self.profile
        spec = seq.tensors[tid]
        dur = self._swap_time(spec.size_bytes)
        tga = seq.tga(tid)
        is_updated_param = spec.updates is not None
        # persistent tensors resident from iteration start can leave any time
        earliest = tga.time if tga is not None else 0.0
        earliest = max(earliest, self.not_before)
        blocked = self._own_access_blocks(tid)
        attempt = SwapAttempt(False, False, False)
        T = max(seq.iteration_time, EPS)

        while latest_time - earliest > EPS:
            out_start = self.channel.earliest_fit(earliest, latest_time, dur, blocked)
            if out_start is None:
                return attempt
            out_end = out_start + dur
            attempt.succeed_swap_out = True

            # --- find the access the swap-in must beat -------------------
            if is_updated_param:
                # across-iteration: first TUA of the aliased parameter in the
                # next iteration (paper Alg 1 line 8-9)
                first = seq.first_tua(spec.updates)
                in_lo = out_end
                in_hi = (T + first.time) if first is not None else 0.0
                crosses = True
            else:
                first = seq.first_tua_after(tid, out_end)
                in_lo = out_end
                in_hi = first.time if first is not None else 0.0
                crosses = False

            if first is None:
                if spec.kind in PERSISTENT_KINDS or spec.kind is TensorKind.OUTPUT \
                        or is_updated_param:
                    # never used again this horizon: eviction alone suffices,
                    # host copy preserves the data
                    self.channel.book(out_start, dur)
                    ev = self._mk_event(EventType.SWAP_OUT, tid, out_start, dur)
                    self.plan.add(ev)
                    attempt.events.append(ev)
                    attempt.succeeded = True
                return attempt
            attempt.have_first_access = True

            in_start = self.channel.latest_fit(in_lo, in_hi, dur, blocked)
            if in_start is not None:
                self.channel.book(out_start, dur)
                self.channel.book(in_start, dur)
                out_ev = self._mk_event(EventType.SWAP_OUT, tid, out_start, dur)
                in_ev = self._mk_event(EventType.SWAP_IN, tid, in_start, dur,
                                       target_op=first.op_idx, crosses=crosses)
                self.plan.add(out_ev)
                self.plan.add(in_ev)
                attempt.events += [out_ev, in_ev]
                attempt.succeeded = True
                # paper: "try to swap-in the rest of accesses greedily" — the
                # host copy persists, so later gaps only need release+swap-in
                if not is_updated_param:
                    self._swap_in_rest(tid, first, dur, blocked)
                return attempt
            # swap-in did not fit before `first`; retry with the swap-out
            # moved past this access (paper Alg 1 line 18-21)
            earliest = max(first.end_time, out_end)
        return attempt

    def _swap_in_rest(self, tid: str, first, dur: float,
                      blocked: List[Tuple[float, float]]) -> None:
        accs = [a for a in self.seq.tensor_accesses(tid)
                if not a.is_tga and a.time > first.time + EPS]
        prev = first
        for a in accs:
            in_start = self.channel.latest_fit(prev.end_time, a.time, dur, blocked)
            if in_start is not None and in_start >= prev.end_time:
                self.channel.book(in_start, dur)
                # release after the previous access, prefetch before this one
                rel = self._mk_event(EventType.RELEASE, tid, prev.end_time, 0.0)
                in_ev = self._mk_event(EventType.SWAP_IN, tid, in_start, dur,
                                       target_op=a.op_idx)
                self.plan.add(rel)
                self.plan.add(in_ev)
            prev = a

    # ------------------------------------------------------------------
    def try_swap_tensor(self, tid: str, peak_time: float) -> bool:
        """Outer loop body of Algorithm 1 (lines 23-34) for one MPT member."""
        seq = self.seq
        spec = seq.tensors.get(tid)
        if spec is None or tid in self.swapped:
            return False
        if (self.max_tensor_bytes is not None
                and spec.size_bytes > self.max_tensor_bytes):
            return False
        accs = seq.tensor_accesses(tid)
        is_updated_param = spec.updates is not None
        if is_updated_param or spec.kind in PERSISTENT_KINDS:
            if not self.cross_iteration:
                return False
            # Opt-phase tensors (paper Alg 1 line 26-27): always eligible —
            # across-iteration scheduling is the point of TENSILE.  The
            # swap-out window extends into the next iteration's prefix,
            # up to the aliased parameter's first TUA (paper Fig. 1(c)).
            T = max(seq.iteration_time, EPS)
            latest = T
            first = seq.first_tua(spec.updates or tid)
            if first is not None:
                latest = T + first.time
            att = self.scheduling_swap(tid, latest_time=latest)
            if att.succeeded:
                self.swapped.add(tid)
            return att.succeeded
        if not self.ratio_allows() or len(accs) <= 1:
            return False
        att = self.scheduling_swap(tid, latest_time=peak_time)
        if att.succeeded:
            self.swapped.add(tid)
        return att.succeeded


def plan_one_swap(planners: Dict[str, "SwapPlanner"],
                  report: PeakReport) -> bool:
    """One greedy step: try MPT members largest-first across all jobs
    (paper: "choose the biggest tensor among all jobs as the most valuable
    tensor to swap")."""
    for storage_id, job_id, _size in report.peak_tensors:
        pl = planners.get(job_id)
        if pl is None:
            continue
        # MPT carries storage ids; map back to swap candidates: prefer the
        # updated-parameter alias (Opt-phase swap) when one exists.
        for tid in pl.alias_candidates.get(storage_id, ()):
            if pl.try_swap_tensor(tid, report.peak_time):
                return True
    return False
