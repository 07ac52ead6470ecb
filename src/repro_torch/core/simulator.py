"""Discrete-event execution simulator, driven by the shared MemoryEngine.

Executes one or more jobs against their scheduling plans on a modeled
machine: sequential operators per job, the engine's single host-DMA channel
for swaps (global exclusivity — cross-job conflicts queue), passive swap-ins
when a prefetch misses its TUA (stall, counted as extra overhead), recompute
time added inline, and the engine's byte-exact residency ledger.

All residency *decisions* (when a planned event applies, when an operand
needs a passive swap-in, when a tensor auto-releases) come from
``engine.JobContext`` — the same rules the interpreting executor runs — so
simulated and real runs of a plan agree by construction.  The simulator owns
only what is genuinely virtual: the clock, transfer completion times, and
stall accounting.

Two transfer modes:
  * ``async`` (default) — transfers overlap compute; completions land at
    their channel-scheduled instant (the paper's Swap Executor).
  * ``sync``  — transfers execute inline at their trigger, serializing with
    compute; mirrors the executor's deterministic sync mode and is what the
    sim-vs-real parity test runs.

Outputs the paper's metrics:
    MSR = (VMP - EMP) / VMP      memory saving ratio
    EOR = (ETC - VTC) / VTC      extra overhead ratio
    CBR = MSR / EOR              cost-benefit ratio
measured against the vanilla (no scheduling) run of the same jobs.

A copy of the JAX package's ``core/simulator.py`` (which imports no JAX),
kept in step with it; the port's tests hold the two to the same
results.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .access import AccessSequence
from .engine import (INPUT_AWAIT_PREFETCH, INPUT_PASSIVE_SWAP_IN,
                     INPUT_RECOMPUTE, INPUT_RESIDENT, JobContext, MemoryEngine)
from .peak_analysis import PERSISTENT_KINDS
from .plan import EventType, MachineProfile, SchedulingPlan
from .telemetry import TelemetryHub


@dataclasses.dataclass
class PlanUpdate:
    """A pending plan change for one running job (preemptive arbitration).

    ``mode="boundary"`` is the paper's rule: the new plan applies right
    before the next iteration starts.  ``mode="safe-point"`` hot-swaps it
    mid-iteration at the first eligible safe point — an op boundary in
    ``safe_ops`` (from ``engine.find_safe_points`` against the *running*
    plan) reached at or after ``at_time`` with no transfer of this job in
    flight.  A safe-point update that finds no eligible point before the
    job's next iteration boundary is discarded there (``applied_time``
    stays None): its remainder plan is stale once the boundary plan takes
    over, and it must not block updates queued behind it.  The simulator
    stamps ``applied_time``/``applied_op`` when a swap lands, so
    scenarios can report the splice latency.
    """

    at_time: float
    plan: SchedulingPlan
    mode: str = "safe-point"            # "safe-point" | "boundary"
    safe_ops: Optional[frozenset] = None
    applied_time: Optional[float] = None
    applied_op: Optional[int] = None    # -1 == applied at the boundary


@dataclasses.dataclass
class SimResult:
    peak_bytes: int
    per_job_time: Dict[str, float]
    per_job_peak: Dict[str, int]
    total_time: float
    stall_time: float
    passive_swap_ins: int
    swap_conflicts: int
    timeline: List[Tuple[float, int]]
    trace: Optional[List[Tuple[str, str, str]]] = None
    # (applied_time, applied_op) per job for every plan update that landed
    plan_swaps: Dict[str, List[Tuple[float, int]]] = \
        dataclasses.field(default_factory=dict)
    # booked-but-unstarted prefetches cancelled when a safe-point splice
    # revised swap-INs already on the DmaChannel
    canceled_swap_ins: int = 0

    def msr(self, vanilla: "SimResult") -> float:
        v = vanilla.peak_bytes
        return (v - self.peak_bytes) / v if v else 0.0

    def eor(self, vanilla: "SimResult") -> float:
        v = vanilla.total_time
        return (self.total_time - v) / v if v else 0.0

    def cbr(self, vanilla: "SimResult") -> float:
        e = self.eor(vanilla)
        m = self.msr(vanilla)
        if e <= 0:
            return float("inf") if m > 0 else 0.0
        return m / e


class _JobClock:
    """Virtual-time state the engine does not own: op cursor, iteration
    count, pending prefetch landing times, queued plan updates."""

    def __init__(self, ctx: JobContext, iterations: int,
                 updates: Optional[List[PlanUpdate]] = None):
        self.ctx = ctx
        self.iterations = iterations
        self.iter = 0
        self.done = False
        self.finish_time = 0.0
        # storage -> completion time of an in-flight planned swap-in
        self.swap_in_at: Dict[str, float] = {}
        # storage -> channel-scheduled START of that swap-in (a booked
        # transfer that has not started yet may be cancelled at a splice)
        self.swap_in_start: Dict[str, float] = {}
        # storage -> identity token of its pending swap_in_done event;
        # cancelled tokens make the event a no-op when it pops
        self.swap_in_token: Dict[str, int] = {}
        self.canceled_tokens: set = set()
        # async swap-outs still in flight (a safe-point splice must wait)
        self.inflight_out = 0
        self.arrived = False    # job_lifecycle: initial residents landed
        self.updates = sorted(updates or [], key=lambda u: u.at_time)


def simulate(seqs: Sequence[AccessSequence],
             plans: Optional[Dict[str, SchedulingPlan]] = None,
             profile: Optional[MachineProfile] = None,
             iterations: Union[int, Dict[str, int]] = 2,
             offsets: Optional[Dict[str, float]] = None,
             free_at_last_use: bool = True,
             job_lifecycle: bool = False,
             transfer_mode: str = "async",
             engine: Optional[MemoryEngine] = None,
             plan_updates: Optional[Dict[str, List[PlanUpdate]]] = None,
             telemetry: Optional[TelemetryHub] = None
             ) -> SimResult:
    """Run `iterations` training iterations of every job concurrently.
    `iterations` may be a per-job dict (dynamic-workload scenarios: short
    jobs finish and leave while long jobs keep running).

    `plan_updates[job_id]` queues mid-run plan changes (PlanUpdate):
    boundary-mode updates land right before the next iteration, safe-point
    updates hot-swap the job's plan at the first eligible safe point.

    `telemetry` attaches a TelemetryHub: the simulator then emits the SAME
    record shapes as the real executor — op latencies, transfer durations,
    stalls, residency mutations — stamped in virtual time, so both
    runtimes stay parity-testable and every measured-telemetry consumer
    can be exercised against the simulator.

    `free_at_last_use=False` reproduces the vanilla platform (nothing is
    released before iteration end — paper §V-A normalizer).

    `job_lifecycle=True` models each job as a process with a lifetime:
    its initial residents are allocated when it ARRIVES (at its offset, in
    event order — not eagerly at sim construction, which would count a
    late-admitted job's parameters against the device from t=0), and when
    it completes its final iteration every byte it still holds is
    returned, with in-flight transfers landing as no-ops.  Service-plane
    scenarios need this — admission takes a job's reservation at admit
    time and releases it at exit, so the modeled device must do the same.
    Default off: the legacy accounting (eager initial residency, residual
    bytes after finish) is what every pre-existing benchmark row was
    recorded under."""
    plans = plans or {}
    offsets = offsets or {}
    plan_updates = plan_updates or {}
    eng = engine or MemoryEngine(profile)
    if telemetry is not None:
        eng.attach_telemetry(telemetry)
    hub = eng.telemetry
    profile = eng.profile

    jobs: Dict[str, _JobClock] = {}
    for s in seqs:
        ctx = eng.add_job(s, plans.get(s.job_id), offsets.get(s.job_id, 0.0))
        # dict form must name every job — a silent default would mask a
        # typo'd job id with quietly-wrong peak/EOR numbers
        iters = (iterations[s.job_id] if isinstance(iterations, dict)
                 else iterations)
        jobs[s.job_id] = _JobClock(ctx, iters,
                                   plan_updates.get(s.job_id))

    stall = 0.0
    passive = 0
    canceled_swap_ins = 0

    # initial residency (paper Alg 2 line 1) — under job_lifecycle it is
    # deferred to each job's arrival event so the ledger's running total
    # stays ordered in virtual time
    if not job_lifecycle:
        for job in jobs.values():
            ctx = job.ctx
            for tid in ctx.seq.initial_resident:
                if tid in ctx.seq.tensors:
                    eng.ledger.alloc(ctx.job_id, ctx.st(tid),
                                     ctx.size_of(tid), ctx.offset)

    # event queue: (time, seqno, kind, job_id, payload)
    q: List[Tuple[float, int, str, str, object]] = []
    seqno = 0

    def push(t: float, kind: str, job_id: str, payload=None):
        nonlocal seqno
        heapq.heappush(q, (t, seqno, kind, job_id, payload))
        seqno += 1

    for job_id, job in jobs.items():
        push(job.ctx.offset, "op", job_id, 0)

    while q:
        t, _, kind, job_id, payload = heapq.heappop(q)
        job = jobs[job_id]
        ctx = job.ctx
        seq = ctx.seq

        if kind == "swap_in_done":
            st, token, s0, dur, compressed, nbytes = payload  # type: ignore[misc]
            if token in job.canceled_tokens:
                # booking was revised away at a safe-point splice before
                # the transfer started: the completion is a no-op
                job.canceled_tokens.discard(token)
                continue
            if job_lifecycle and job.done:
                # the job exited while this prefetch was on the wire: the
                # landing bytes have nowhere to go — drop the completion
                job.swap_in_at.pop(st, None)
                job.swap_in_start.pop(st, None)
                job.swap_in_token.pop(st, None)
                continue
            if hub is not None:
                hub.record_transfer(job_id, st, "in", nbytes, dur,
                                    compressed=compressed, t=s0)
            eng.complete_swap_in(ctx, st, t)
            job.swap_in_at.pop(st, None)
            job.swap_in_start.pop(st, None)
            job.swap_in_token.pop(st, None)
            continue
        if kind == "swap_out_done":
            st, compressed = payload  # type: ignore[misc]
            if job_lifecycle and job.done:
                # device side already freed wholesale at exit
                job.inflight_out -= 1
                continue
            eng.complete_swap_out(ctx, st, t, compressed=compressed)
            job.inflight_out -= 1
            continue
        if kind != "op":
            continue

        op_idx = payload  # type: ignore[assignment]
        op = seq.operators[op_idx]

        if job_lifecycle and not job.arrived:
            # process arrival: the job's parameters land on device now
            job.arrived = True
            for tid in seq.initial_resident:
                if tid in seq.tensors:
                    eng.ledger.alloc(ctx.job_id, ctx.st(tid),
                                     ctx.size_of(tid), t)

        # ---- ensure inputs resident (engine decision; paper Executor) --
        start = t
        for tid in op.inputs:
            if tid not in seq.tensors:
                continue
            st = ctx.st(tid)
            action = ctx.input_action(eng.ledger, tid,
                                      prefetch_inflight=st in job.swap_in_at)
            if action is INPUT_RESIDENT:
                continue
            if action is INPUT_AWAIT_PREFETCH:
                # prefetch in flight but late: wait for it
                wait_until = job.swap_in_at.pop(st)
                job.swap_in_start.pop(st, None)
                wait = max(0.0, wait_until - start)
                stall += wait
                if hub is not None and wait > 0:
                    hub.record_stall(job_id, op_idx, wait,
                                     "await_prefetch", t=start)
                start = max(start, wait_until)
                eng.complete_swap_in(ctx, st, start, passive=True)
                passive += 1
            elif action is INPUT_PASSIVE_SWAP_IN:
                # passive swap-in: block on the channel (Capuchin-style
                # overhead — what TENSILE's planned prefetch avoids)
                compressed = st in ctx.host_compressed
                dur = profile.transfer_time(
                    ctx.size_of(tid), compressed=compressed)
                s0, s1 = eng.channel.acquire(
                    start, dur, direction="in",
                    fixup=profile.host_link_latency)
                if hub is not None:
                    hub.record_transfer(job_id, st, "in",
                                        ctx.size_of(tid), dur,
                                        compressed=compressed,
                                        passive=True, t=s0)
                    hub.record_stall(job_id, op_idx, s1 - start,
                                     "passive_in", t=start)
                stall += s1 - start
                start = s1
                eng.complete_swap_in(ctx, st, start, passive=True)
                passive += 1
            # INPUT_RECOMPUTE: never materialized — a planned recompute
            # event regenerates it at its trigger; nothing to charge here
            # (the TGA allocation below models on-demand regeneration).

        # ---- run the op -------------------------------------------------
        end = start + op.latency
        if hub is not None:
            hub.record_op(job_id, op_idx, op.latency, prim=op.name,
                          flops=op.flops, bytes_accessed=op.bytes_accessed,
                          t=end)

        # ---- allocate outputs (TGA; updated params alias old storage, so
        # the storage-keyed alloc is a no-op while the old copy is resident)
        for tid in op.outputs:
            if tid not in seq.tensors:
                continue
            eng.ledger.alloc(ctx.job_id, ctx.st(tid), ctx.size_of(tid), end)

        # ---- releases (plan override + activity analysis) ---------------
        for tid in op.inputs + op.outputs:
            if tid not in seq.tensors:
                continue
            if ctx.should_auto_release(tid, op_idx, free_at_last_use):
                eng.record("release", ctx, ctx.st(tid))
                eng.ledger.free(ctx.job_id, ctx.st(tid), end)

        # ---- plan events triggered by this op ---------------------------
        for ev in ctx.events_triggered_by(op_idx):
            st = ctx.st(ev.tensor_id)
            if not ctx.event_applies(eng.ledger, ev):
                continue
            if ev.event_type is EventType.SWAP_OUT:
                dur = eng.event_duration(ev)
                s0, s1 = eng.channel.acquire(
                    end + max(ev.delta, 0.0), dur, direction="out",
                    fixup=profile.host_link_latency)
                if hub is not None:
                    hub.record_transfer(job_id, st, "out", ev.size_bytes,
                                        dur, compressed=ev.compressed,
                                        t=s0)
                if transfer_mode == "sync":
                    end = max(end, s1)
                    eng.complete_swap_out(ctx, st, end,
                                          compressed=ev.compressed)
                else:
                    job.inflight_out += 1
                    push(s1, "swap_out_done", job_id, (st, ev.compressed))
            elif ev.event_type is EventType.SWAP_IN:
                dur = eng.event_duration(ev)
                s0, s1 = eng.channel.acquire(
                    end + max(ev.delta, 0.0), dur, direction="in",
                    fixup=profile.host_link_latency)
                if transfer_mode == "sync":
                    if hub is not None:
                        hub.record_transfer(job_id, st, "in",
                                            ev.size_bytes, dur,
                                            compressed=ev.compressed,
                                            t=s0)
                    end = max(end, s1)
                    eng.complete_swap_in(ctx, st, end)
                else:
                    # the transfer is recorded into the hub only at
                    # COMPLETION: a booking cancelled at a safe-point
                    # splice must not leave a phantom busy interval in
                    # the measured plane
                    job.swap_in_at[st] = s1
                    job.swap_in_start[st] = s0
                    token = seqno  # unique: push() bumps it next
                    job.swap_in_token[st] = token
                    push(s1, "swap_in_done", job_id,
                         (st, token, s0, dur, ev.compressed,
                          ev.size_bytes))
            elif ev.event_type is EventType.RELEASE:
                eng.record("release", ctx, st)
                eng.ledger.free(ctx.job_id, st, end)
            elif ev.event_type is EventType.RECOMPUTE:
                # re-execute the producer chain inline (serial job)
                rc = sum(seq.operators[i].latency
                         for i in (ev.recompute_ops or []))
                end += rc
                eng.record("recompute", ctx, st)
                eng.ledger.alloc(ctx.job_id, st, ctx.size_of(ev.tensor_id),
                                 end)

        # ---- plan hot-swap at a safe point ------------------------------
        # after this op's events: the splice adopts the new plan's triggers
        # for every LATER op, the prefix already ran identically.  Every
        # due update is scanned — a safe-point update must not be blocked
        # by a boundary update queued ahead of it — and the LAST eligible
        # one wins (it was built to supersede its predecessors); the
        # superseded ones are dropped.  A swap-IN already booked on the
        # channel no longer pins the plan: a booking whose transfer has
        # not STARTED by the splice instant is cancelled (and the channel
        # tail refunded best-effort) so the new plan can re-book it; only
        # a transfer physically on the wire defers the splice.
        started_in = any(s0 <= end + 1e-12
                         for s0 in job.swap_in_start.values())
        if job.updates and not started_in and job.inflight_out == 0:
            hit = None
            for i, upd in enumerate(job.updates):
                if upd.at_time > end + 1e-12:
                    break
                if upd.mode == "safe-point" \
                        and (upd.safe_ops is None or op_idx in upd.safe_ops):
                    hit = i
            if hit is not None:
                upd = job.updates[hit]
                # cancel unstarted booked swap-ins, newest booking first
                # (the FIFO channel can only refund its tail)
                for st_c, s0 in sorted(job.swap_in_start.items(),
                                       key=lambda kv: -kv[1]):
                    s1 = job.swap_in_at.pop(st_c, None)
                    token = job.swap_in_token.pop(st_c, None)
                    if token is not None:
                        job.canceled_tokens.add(token)
                    if s1 is not None:
                        eng.channel.try_refund(s0, s1)
                    canceled_swap_ins += 1
                job.swap_in_start.clear()
                ctx.set_plan(upd.plan)
                upd.applied_time, upd.applied_op = end, op_idx
                if eng.recorder is not None:
                    eng.recorder.instant("hot_swap", end, job_id=job_id,
                                         site="safe-point", op_idx=op_idx)
                # superseded SAFE-POINT updates are dropped; pending
                # boundary updates survive — a spliced remainder plan is
                # only certified for this iteration's window, so the full
                # boundary plan must still land at the boundary drain
                job.updates = [u for i, u in enumerate(job.updates)
                               if i > hit or u.mode == "boundary"]

        # ---- advance ------------------------------------------------------
        nxt = op_idx + 1
        if nxt < len(seq.operators):
            push(end, "op", job_id, nxt)
        else:
            if not free_at_last_use:
                # vanilla platform: iteration-end free of non-persistent
                for st in eng.ledger.resident_storages(ctx.job_id):
                    if not _persistent_storage(seq, st):
                        eng.ledger.free(ctx.job_id, st, end)
            job.iter += 1
            if hub is not None:
                hub.end_iteration(job_id)
            # boundary-mode plan pickup: "right before computing the next
            # batch of data" (paper §III-D).  ALL due updates drain here:
            # a safe-point update whose window has passed is obsolete (the
            # boundary plan supersedes the mid-iteration shrink it never
            # managed to apply), and of several due boundary updates only
            # the NEWEST takes effect — each was built to replace its
            # predecessors.
            last_boundary = None
            while job.updates and job.updates[0].at_time <= end + 1e-12:
                upd = job.updates.pop(0)
                if upd.mode == "boundary":
                    last_boundary = upd
            if last_boundary is not None:
                ctx.set_plan(last_boundary.plan)
                last_boundary.applied_time = end
                last_boundary.applied_op = -1
                if eng.recorder is not None:
                    eng.recorder.instant("hot_swap", end, job_id=job_id,
                                         site="boundary", op_idx=-1)
            if job.iter < job.iterations:
                push(end, "op", job_id, 0)
            else:
                job.done = True
                job.finish_time = end
                if job_lifecycle:
                    # process exit: return every byte the job still holds
                    for st in eng.ledger.resident_storages(ctx.job_id):
                        eng.ledger.free(ctx.job_id, st, end)

    per_job_time = {j: (job.finish_time - job.ctx.offset)
                    / max(job.iterations, 1)
                    for j, job in jobs.items()}
    per_job_peak = {j: eng.ledger.job_peak(j) for j in jobs}
    total = max((job.finish_time for job in jobs.values()), default=0.0)
    plan_swaps = {
        j: [(u.applied_time, u.applied_op)
            for u in plan_updates.get(j, []) if u.applied_time is not None]
        for j in jobs if plan_updates.get(j)}
    return SimResult(
        peak_bytes=eng.ledger.peak, per_job_time=per_job_time,
        per_job_peak=per_job_peak, total_time=total, stall_time=stall,
        passive_swap_ins=passive, swap_conflicts=eng.channel.conflicts,
        timeline=list(eng.ledger.timeline),
        trace=eng.trace.keys() if eng.trace else None,
        plan_swaps=plan_swaps, canceled_swap_ins=canceled_swap_ins)


def _persistent_storage(seq: AccessSequence, st: str) -> bool:
    spec = seq.tensors.get(st)
    return spec is not None and (spec.kind in PERSISTENT_KINDS
                                 or spec.updates is not None)


def evaluate(seqs: Sequence[AccessSequence],
             plans: Optional[Dict[str, SchedulingPlan]],
             profile: Optional[MachineProfile] = None,
             iterations: Union[int, Dict[str, int]] = 3,
             offsets: Optional[Dict[str, float]] = None,
             free_at_last_use: bool = True,
             ) -> Dict[str, float]:
    """Run scheduled vs vanilla and report the paper's metrics.  The
    vanilla run frees nothing until iteration end (the paper's platform);
    scheduled runs get activity-analysis releases (Alg 3 line 2) unless
    the method's own framework lacks them (vDNN: swap-only)."""
    vanilla = simulate(seqs, None, profile, iterations, offsets,
                       free_at_last_use=False)
    sched = simulate(seqs, plans, profile, iterations, offsets,
                     free_at_last_use=free_at_last_use)
    msr = sched.msr(vanilla)
    eor = sched.eor(vanilla)
    return {
        "MSR": msr, "EOR": eor,
        "CBR": sched.cbr(vanilla),
        "vanilla_peak": vanilla.peak_bytes, "peak": sched.peak_bytes,
        "vanilla_time": vanilla.total_time, "time": sched.total_time,
        "stall_time": sched.stall_time,
        "passive_swap_ins": sched.passive_swap_ins,
        "swap_conflicts": sched.swap_conflicts,
    }
