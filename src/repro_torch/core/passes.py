"""Composable planning passes + the Pipeline that drives them (paper §IV-F).

TENSILE's core claim (Alg. 3) is that swap and recomputation are
*interchangeable actions scheduled per-tensor under one peak-analysis loop*.
This module makes that loop a first-class, policy-agnostic driver:

  * ``PlanningPass``  — the protocol every planning strategy implements:
        ``run(seq, plan, report, profile) -> plan``
    plus an incremental interface (``setup``/``gate``/``step``) the Pipeline
    uses to interleave passes one greedy action at a time, exactly as
    Algorithm 3 interleaves swapping and recomputation.
  * ``Pipeline``      — owns the convergence loop (patience, minimum
    improvement, iteration cap) and the vanilla/planned peak bookkeeping.
    Passes are tried in order; a pass that can no longer make progress is
    retired; the loop ends when no gated pass remains or the peak stagnates.

Every policy in the repo — the paper's TENSILE scheduler and both
reproduced baselines — is now a pass configuration over this one engine:

    vanilla  = Pipeline([])
    vdnn     = Pipeline([VdnnSwapPass])
    capuchin = Pipeline([PassiveProfilePass, SwapPass(style="capuchin"),
                         RecomputePass(style="capuchin")])
    tensile  = Pipeline([SwapPass(), RecomputePass()], cross_iteration=True)
    tensile+compressed-offload
             = Pipeline([SwapPass(), CompressedOffloadPass(),
                         RecomputePass()], cross_iteration=True)
    tensile+priority
             = Pipeline([PriorityPass(), RecomputePass()],
                        cross_iteration=True)
    tensile+autoscale
             = Pipeline([SwapPass(), BudgetAutoscalePass(),
                         RecomputePass()], cross_iteration=True)

The two cross-job pipelines plan against *arbiter-assigned per-job budgets*
(``SchedulerConfig.per_job_budget_bytes``, filled in by the Global
Controller's ``BudgetArbiter`` on every launch/finish/drift replan) instead
of the full device: ``PriorityPass`` picks swap victims from the
lowest-priority over-share jobs first, and ``BudgetAutoscalePass`` keeps
swapping the most over-budget job until every job fits its assigned slice.

New policies are one-file additions: implement the protocol, register a
configuration in ``PIPELINES``.

A copy of the JAX package's ``core/passes.py`` (which imports no JAX),
kept in step with it; the port's tests hold the two to the same
results.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from .access import AccessSequence, AccessType, TensorKind
from .peak_analysis import (PERSISTENT_KINDS, PeakReport, WindowSweep,
                            analyze, storage_of)
from .plan import (EventType, MachineProfile, ScheduleEvent, SchedulingPlan)
from .recompute_planner import RecomputePlanner, plan_one_recompute
from .swap_planner import SwapPlanner, plan_one_swap

# the reference's jaxpr primitives, and their aten counterparts in this
# package's captures
HEAVY_OPS = {"dot_general", "conv_general_dilated", "mm", "addmm", "bmm",
             "baddbmm", "convolution"}


# ----------------------------------------------------------------------
# Configuration + result (Alg. 3 knobs; shared with MemoryScheduler)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class SchedulerConfig:
    memory_budget_bytes: Optional[int] = None   # None: device size from profile
    max_swap_ratio: float = 1.0                 # per-job MSR limit (can be dict)
    per_job_swap_ratio: Optional[Dict[str, float]] = None
    min_improvement: float = 5e-4               # 0.05 % (paper Alg 3)
    patience_iters: int = 100
    patience_window: int = 3
    update_threshold: float = 0.2               # latency-drift replan trigger
    ewma_alpha: float = 0.3
    max_iterations: int = 10000
    # quantize-on-offload: only tensors at or below this size take the
    # compressed path (confines int8 error to small peak contributors)
    compressed_max_bytes: int = 64 * 2 ** 20
    # cross-job arbitration (filled in by the Global Controller's
    # BudgetArbiter on every launch/finish/drift replan): per-job byte
    # budgets the pipelines plan against instead of the full device, and
    # per-job priority weights (default 1.0) PriorityPass uses to pick
    # swap victims from low-priority jobs first
    per_job_budget_bytes: Optional[Dict[str, int]] = None
    job_priorities: Optional[Dict[str, float]] = None
    # when the arbiter shrinks a live job's slice: "boundary" applies the
    # new plan at the next iteration boundary (the paper's rule), "preempt"
    # additionally hot-swaps an incremental remainder plan in at the job's
    # next safe point (engine.find_safe_points), so the slice is respected
    # mid-iteration instead of an iteration later
    arbiter_mode: str = "boundary"


@dataclasses.dataclass
class ScheduleResult:
    plans: Dict[str, SchedulingPlan]
    initial_report: PeakReport
    final_report: PeakReport
    iterations: int
    swaps_scheduled: int
    recomputes_scheduled: int
    plan_wallclock_s: float
    pass_steps: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def memory_saving_ratio(self) -> float:
        """MSR against the merged vanilla peak (paper §V-A)."""
        v = self.initial_report.peak_bytes
        return (v - self.final_report.peak_bytes) / v if v else 0.0


@dataclasses.dataclass
class PipelineState:
    """Everything passes share while a Pipeline converges."""
    jobs: Dict[str, AccessSequence]
    plans: Dict[str, SchedulingPlan]
    profile: MachineProfile
    config: SchedulerConfig
    offsets: Dict[str, float]
    budget: int
    cross_iteration: bool = True
    shared: Dict[str, object] = dataclasses.field(default_factory=dict)
    # arbiter-assigned per-job byte budgets; empty = every job plans
    # against the shared device-wide `budget` (single-job / legacy mode)
    job_budgets: Dict[str, int] = dataclasses.field(default_factory=dict)

    def priority_of(self, job_id: str) -> float:
        return (self.config.job_priorities or {}).get(job_id, 1.0)

    @staticmethod
    def solo(seq: AccessSequence, plan: SchedulingPlan,
             profile: Optional[MachineProfile],
             config: Optional[SchedulerConfig] = None) -> "PipelineState":
        profile = profile or MachineProfile()
        cfg = config or SchedulerConfig()
        return PipelineState(
            jobs={seq.job_id: seq}, plans={seq.job_id: plan},
            profile=profile, config=cfg, offsets={},
            budget=(cfg.memory_budget_bytes
                    if cfg.memory_budget_bytes is not None
                    else profile.device_memory_bytes))


def _solo_report(state: "PipelineState", job_id: str,
                 cache: Dict[str, Tuple[Tuple[int, int], PeakReport]]
                 ) -> PeakReport:
    """A job's own-timeline peak report, cached until its plan changes —
    the arbiter passes consult it once per greedy step per offender, and
    only the job whose plan was just modified ever goes stale."""
    plan = state.plans[job_id]
    key = (len(plan.events), len(plan.release_after_op))
    hit = cache.get(job_id)
    if hit is not None and hit[0] == key:
        return hit[1]
    rep = analyze([state.jobs[job_id]], plans={job_id: plan})
    cache[job_id] = (key, rep)
    return rep


def over_budget_jobs(state: "PipelineState",
                     report: PeakReport) -> Dict[str, int]:
    """job -> excess bytes over its arbiter-assigned budget.  Per-job peaks
    bound the global peak (at any instant each job holds at most its own
    peak), so driving every excess to zero certifies the device budget."""
    out: Dict[str, int] = {}
    for j, b in state.job_budgets.items():
        excess = report.per_job_peak.get(j, 0) - b
        if excess > 0:
            out[j] = excess
    return out


# ----------------------------------------------------------------------
# The pass protocol
# ----------------------------------------------------------------------
class PlanningPass:
    """A composable planning strategy.

    Protocol: ``run(seq, plan, report, profile) -> plan`` plans one job to
    exhaustion.  Pipelines use the finer-grained hooks instead — ``setup``
    binds the pass to the job set, ``gate`` says whether it may act under
    the current report, ``step`` performs ONE greedy action and returns
    whether it changed any plan — so several passes interleave under one
    convergence loop (Alg. 3's swap/recompute interleaving generalized).
    """

    name = "pass"
    kind = "swap"          # counted as swap or recompute in ScheduleResult

    def setup(self, state: PipelineState) -> None:
        self.state = state

    def gate(self, report: PeakReport) -> bool:
        return True

    def step(self, report: PeakReport) -> bool:
        raise NotImplementedError

    def run(self, seq: AccessSequence, plan: SchedulingPlan,
            report: PeakReport,
            profile: Optional[MachineProfile] = None) -> SchedulingPlan:
        """Standalone single-job entry point (the protocol)."""
        self.setup(PipelineState.solo(seq, plan, profile))
        while self.gate(report) and self.step(report):
            report = analyze([seq], plans={seq.job_id: plan})
        return plan


# ----------------------------------------------------------------------
# TENSILE passes (Algorithms 1 & §IV-D wrapped as passes)
# ----------------------------------------------------------------------
class SwapPass(PlanningPass):
    """Greedy swap scheduling (paper Alg. 1): one MPT tensor per step,
    largest first across all jobs.  ``style="capuchin"`` instead replays the
    swap half of the Capuchin candidate walk prepared by
    PassiveProfilePass."""

    name = "swap"
    kind = "swap"

    def __init__(self, style: str = "tensile"):
        self.style = style

    def setup(self, state: PipelineState) -> None:
        super().setup(state)
        cfg = state.config
        if self.style == "tensile":
            self.planners = {
                j: SwapPlanner(state.jobs[j], state.plans[j], state.profile,
                               (cfg.per_job_swap_ratio or {}).get(
                                   j, cfg.max_swap_ratio),
                               cross_iteration=state.cross_iteration,
                               telemetry=state.shared.get("telemetry"),
                               experience=state.shared.get("experience"))
                for j in state.jobs}

    def step(self, report: PeakReport) -> bool:
        if self.style == "capuchin":
            return _capuchin_step(self.state, want="swap")
        return plan_one_swap(self.planners, report)


class RecomputePass(PlanningPass):
    """MSPS-ranked recomputation (paper §IV-D): gated on the predicted peak
    still exceeding the budget, runs only after swapping is exhausted (the
    Pipeline's pass order encodes that, exactly like Alg. 3)."""

    name = "recompute"
    kind = "recompute"

    def __init__(self, style: str = "tensile"):
        self.style = style

    def setup(self, state: PipelineState) -> None:
        super().setup(state)
        self._solo_cache: Dict[str, Tuple[Tuple[int, int], PeakReport]] = {}
        if self.style == "tensile":
            exp = state.shared.get("experience")
            self.planners = {
                j: RecomputePlanner(state.jobs[j], state.plans[j],
                                    experience=exp)
                for j in state.jobs}

    def gate(self, report: PeakReport) -> bool:
        if self.style == "capuchin":
            return True
        # over the device budget, or (under the arbiter) any job over its
        # assigned slice — swap passes retire first, so recomputation is the
        # remaining lever to certify the split
        return report.peak_bytes >= self.state.budget \
            or bool(over_budget_jobs(self.state, report))

    def step(self, report: PeakReport) -> bool:
        if self.style == "capuchin":
            return _capuchin_step(self.state, want="recompute")
        if plan_one_recompute(self.planners, report):
            return True
        # arbiter mode: a job can violate its slice away from the global
        # peak instant; retry against the offenders' solo reports
        state = self.state
        over = over_budget_jobs(state, report)
        for job_id in sorted(over, key=lambda j: -over[j]):
            rep_j = _solo_report(state, job_id, self._solo_cache)
            if plan_one_recompute({job_id: self.planners[job_id]}, rep_j):
                return True
        return False


class CompressedOffloadPass(PlanningPass):
    """Beyond-paper policy: tensors still causing the peak after plain
    swapping get another chance through the Pallas quantize-on-offload path
    (kernels/offload_quant) — the channel booking shrinks to the compressed
    transfer time (plan.MachineProfile.compressed_swap_time, calibrated by
    cost_model.offload_quant_latency), so windows too tight for a full-
    precision swap can still hide an int8 copy.  Restricted to tensors at or
    below ``compressed_max_bytes`` to confine quantization error."""

    name = "compressed-offload"
    kind = "swap"

    def setup(self, state: PipelineState) -> None:
        super().setup(state)
        self.planners = None   # built lazily: picks up prior passes' events

    def _build(self) -> None:
        state = self.state
        cfg = state.config
        self.planners = {
            j: SwapPlanner(state.jobs[j], state.plans[j], state.profile,
                           (cfg.per_job_swap_ratio or {}).get(
                               j, cfg.max_swap_ratio),
                           cross_iteration=state.cross_iteration,
                           compressed=True,
                           max_tensor_bytes=cfg.compressed_max_bytes,
                           telemetry=state.shared.get("telemetry"),
                           experience=state.shared.get("experience"))
            for j in state.jobs}

    def step(self, report: PeakReport) -> bool:
        if self.planners is None:
            self._build()
        state = self.state
        seqs = list(state.jobs.values())
        # a swap pair can also EXTEND residency (the swap-in supersedes the
        # activity-analysis release), so unlike plain Alg-1 greed each
        # compressed step is verified against the peak and rolled back if
        # it does not help; rejected tensors stay marked and are not retried
        while True:
            before = {j: len(state.plans[j].events) for j in state.plans}
            if not plan_one_swap(self.planners, report):
                return False
            new_report = analyze(seqs, plans=state.plans,
                                 offsets=state.offsets)
            # strict improvement only: a zero-saving compressed swap still
            # costs two transfers plus a lossy int8 round trip
            if new_report.peak_bytes < report.peak_bytes:
                return True
            for j, n in before.items():
                plan = state.plans[j]
                added = plan.events[n:]
                for ev in added:
                    if ev.event_type in (EventType.SWAP_OUT,
                                         EventType.SWAP_IN):
                        try:
                            self.planners[j].channel.release(
                                ev.start, ev.duration)
                        except ValueError:
                            pass
                    plan.remove(ev)


# ----------------------------------------------------------------------
# Cross-job arbitration passes (ROADMAP: cross-job priority + budget
# autoscaling) — plan against arbiter-assigned per-job budgets
# ----------------------------------------------------------------------
def _build_swap_planners(state: PipelineState) -> Dict[str, "SwapPlanner"]:
    cfg = state.config
    return {
        j: SwapPlanner(state.jobs[j], state.plans[j], state.profile,
                       (cfg.per_job_swap_ratio or {}).get(
                           j, cfg.max_swap_ratio),
                       cross_iteration=state.cross_iteration,
                       telemetry=state.shared.get("telemetry"),
                       experience=state.shared.get("experience"))
        for j in state.jobs}


class PriorityPass(PlanningPass):
    """Priority-weighted swap scheduling: like SwapPass, but the victim
    order is cross-job-aware.  Jobs exceeding their arbiter-assigned budget
    are tried first, lowest priority first (largest tensor within a job);
    jobs inside their share are only touched once no over-share job can
    make progress — so a high-priority job keeps (at least) its weighted
    slice of the device while low-priority jobs absorb the swapping."""

    name = "priority-swap"
    kind = "swap"

    def setup(self, state: PipelineState) -> None:
        super().setup(state)
        self.planners = _build_swap_planners(state)

    def _victim_order(self, report: PeakReport):
        state = self.state
        over = over_budget_jobs(state, report)
        # when no per-job budgets were assigned every job counts as "over"
        # (pure priority ordering over the whole MPT)
        def tier(job_id: str) -> int:
            if not state.job_budgets:
                return 0
            return 0 if job_id in over else 1
        return sorted(
            report.peak_tensors,
            key=lambda t: (tier(t[1]), state.priority_of(t[1]), -t[2]))

    def step(self, report: PeakReport) -> bool:
        for storage_id, job_id, _size in self._victim_order(report):
            pl = self.planners.get(job_id)
            if pl is None:
                continue
            for tid in pl.alias_candidates.get(storage_id, ()):
                if pl.try_swap_tensor(tid, report.peak_time):
                    return True
        return False


class BudgetAutoscalePass(PlanningPass):
    """Budget autoscaling enforcement: while any job's per-job peak exceeds
    its arbiter-assigned slice, swap one tensor from the most over-budget
    job.  Runs after plain SwapPass retires (pipeline order), so it only
    adds the job-targeted swaps global largest-first greed missed; planners
    are built lazily to pick up the earlier passes' channel bookings."""

    name = "budget-autoscale"
    kind = "swap"

    def setup(self, state: PipelineState) -> None:
        super().setup(state)
        self.planners: Optional[Dict[str, SwapPlanner]] = None
        self._solo_cache: Dict[str, Tuple[Tuple[int, int], PeakReport]] = {}

    def gate(self, report: PeakReport) -> bool:
        return bool(over_budget_jobs(self.state, report))

    def step(self, report: PeakReport) -> bool:
        if self.planners is None:
            self.planners = _build_swap_planners(self.state)
        state = self.state
        over = over_budget_jobs(state, report)
        for job_id in sorted(over, key=lambda j: -over[j]):
            pl = self.planners.get(job_id)
            if pl is None:
                continue
            # a job's budget violation peaks at ITS OWN peak instant, which
            # need not coincide with the merged global peak — target the
            # job's solo report (per-job residency is plan-local, so the
            # solo peak equals the job's per_job_peak in the merged one)
            rep_j = _solo_report(state, job_id, self._solo_cache)
            for storage_id, _owner, _size in rep_j.peak_tensors:
                for tid in pl.alias_candidates.get(storage_id, ()):
                    if pl.try_swap_tensor(tid, rep_j.peak_time):
                        return True
        return False


class PreemptiveReplanPass(PlanningPass):
    """Incremental mid-iteration replan (safe-point plan hot-swap).

    Used by ``Pipeline.replan_from``: each job's plan is a *copy of the
    plan currently executing*, and this pass may only add events strictly
    after the job's safe point (``state.shared["replan_from_op"]``) — the
    prefix has already run, so the runtime can splice the result in at the
    safe point without tearing the iteration.  Victims are driven to their
    (shrunken) arbiter slice by eager swap-outs: the SwapPlanner's
    ``not_before`` pins every new event into the remainder window and
    earliest-fit placement lands the swap-out right at the safe point.

    Peaks are judged on the *remainder window* ``[t_safe, T)`` of each
    job's own timeline: bytes resident before the safe point are history
    this pass cannot undo, but they persist into the window, so the
    windowed per-job peak is exactly "will job j fit its new slice from
    the splice on".

    When the windowed swap budget is infeasible — no eager swap-out pair
    fits the remainder of the DMA channel — the pass may emit RECOMPUTE
    actions instead (release now, regenerate at the next use), gated by
    the same per-step windowed-peak verification and rolled back when
    they do not strictly improve the window.
    """

    name = "preemptive-replan"
    kind = "swap"

    def setup(self, state: PipelineState) -> None:
        super().setup(state)
        cfg = state.config
        self.from_op: Dict[str, int] = dict(
            state.shared.get("replan_from_op", {}))
        self.from_time: Dict[str, float] = {}
        self.planners: Dict[str, SwapPlanner] = {}
        self.rec_planners: Dict[str, RecomputePlanner] = {}
        self._window_cache: Dict[str, Tuple[Tuple[int, int], PeakReport]] = {}
        # per-job incremental sweeps; Pipeline.replan_from shares its
        # cross-replan cache through state.shared so a job's frozen prefix
        # survives consecutive replans at the same safe point
        self._sweeps: Dict[str, WindowSweep] = state.shared.setdefault(
            "window_sweeps", {})
        for j, op in self.from_op.items():
            seq = state.jobs.get(j)
            if seq is None:
                continue
            # new events must TRIGGER strictly after the safe-point op —
            # the splice happens after op `op`'s events fired, so anything
            # keyed to trigger <= op would never run.  The planner's
            # trigger mapping assigns trigger k to starts in
            # [op_end[k], op_end[k+1]), so a start at or after
            # op_end[op+1] gets trigger >= op+1 — hence the +1.
            nxt = min(op + 1, len(seq.op_end) - 1)
            t0 = seq.op_end[nxt] if seq.op_end else 0.0
            self.from_time[j] = t0
            pl = SwapPlanner(
                seq, state.plans[j], state.profile,
                (cfg.per_job_swap_ratio or {}).get(j, cfg.max_swap_ratio),
                cross_iteration=state.cross_iteration,
                not_before=t0,
                telemetry=state.shared.get("telemetry"),
                experience=state.shared.get("experience"))
            # tensors the running plan already swaps are eligible AGAIN:
            # under the shrunken slice an extra eviction + re-fetch pair in
            # the remainder window is exactly the lever left (runtime skip
            # rules make duplicate events at the same trigger harmless)
            pl.swapped.clear()
            self.planners[j] = pl

    def _window_report(self, job_id: str) -> PeakReport:
        seq = self.state.jobs[job_id]
        plan = self.state.plans[job_id]
        key = (plan.version, len(plan.release_after_op))
        hit = self._window_cache.get(job_id)
        if hit is not None and hit[0] == key:
            return hit[1]
        sweep = self._sweeps.get(job_id)
        if sweep is None:
            sweep = self._sweeps[job_id] = WindowSweep(
                free_at_last_use=True)
        rep = sweep.report(seq, plan, self.from_time[job_id],
                           seq.iteration_time + 1e-12)
        self._window_cache[job_id] = (key, rep)
        return rep

    def _excess(self, job_id: str) -> int:
        budget = self.state.job_budgets.get(job_id)
        if budget is None:
            return 0
        # single-job report: the window-restricted global peak IS the job's
        # windowed peak (per_job_peak ignores the window by design)
        rep = self._window_report(job_id)
        return max(0, rep.peak_bytes - budget)

    def gate(self, report: Optional[PeakReport]) -> bool:
        return any(self._excess(j) > 0 for j in self.planners)

    def step(self, report: Optional[PeakReport]) -> bool:
        over = {j: e for j in self.planners
                if (e := self._excess(j)) > 0}
        for job_id in sorted(over, key=lambda j: -over[j]):
            pl = self.planners[job_id]
            plan = self.state.plans[job_id]
            rep = self._window_report(job_id)
            for storage_id, _owner, _size in rep.peak_tensors:
                for tid in pl.alias_candidates.get(storage_id, ()):
                    n0 = len(plan.events)
                    if not pl.try_swap_tensor(tid, rep.peak_time):
                        continue
                    # a swap pair can also EXTEND residency (the re-fetch
                    # supersedes releases), so — like CompressedOffloadPass
                    # — every step is verified against the windowed peak
                    # and rolled back when it does not strictly improve;
                    # the tensor stays marked and is not retried
                    self._window_cache.pop(job_id, None)
                    if self._window_report(job_id).peak_bytes \
                            < rep.peak_bytes:
                        return True
                    for ev in plan.events[n0:]:
                        if ev.event_type in (EventType.SWAP_OUT,
                                             EventType.SWAP_IN):
                            try:
                                pl.channel.release(ev.start, ev.duration)
                            except ValueError:
                                pass
                    plan.truncate(n0)
                    self._window_cache.pop(job_id, None)
            # the windowed swap budget is infeasible for this job (no
            # eager swap-out pair fits the remaining channel time):
            # recomputation is the lever left — release now, regenerate
            # at the next use, same per-step peak verification
            if self._try_recompute(job_id, rep):
                return True
        return False

    def _try_recompute(self, job_id: str,
                       rep: PeakReport) -> bool:
        """One recompute action strictly inside the remainder window,
        verified against the windowed peak and rolled back when it does
        not strictly improve (rejected tensors stay marked)."""
        plan = self.state.plans[job_id]
        rp = self.rec_planners.get(job_id)
        if rp is None:
            rp = self.rec_planners[job_id] = RecomputePlanner(
                self.state.jobs[job_id], plan,
                experience=self.state.shared.get("experience"))
        from_op = self.from_op.get(job_id, -1)
        for cand in rp.candidates(rep):
            # both events must TRIGGER strictly after the safe-point op —
            # anything at or before it would never fire post-splice
            if (cand.release_after_op <= from_op
                    or max(cand.target_op - 1, 0) <= from_op):
                continue
            n0 = len(plan.events)
            rp.apply(cand)
            self._window_cache.pop(job_id, None)
            if self._window_report(job_id).peak_bytes < rep.peak_bytes:
                return True
            plan.truncate(n0)
            self._window_cache.pop(job_id, None)
        return False


# ----------------------------------------------------------------------
# vDNN_conv (Rhu et al., MICRO'16) as a one-shot pass
# ----------------------------------------------------------------------
class VdnnSwapPass(PlanningPass):
    """*Layer* granularity: offload the feature maps of the heavy
    ("conv-like") layers after their forward use, static swap-in (prefetch
    when the previous backward layer starts).  No recomputation, no
    Opt-phase events, single-workload design — one shot per job."""

    name = "vdnn-swap"
    kind = "swap"

    def setup(self, state: PipelineState) -> None:
        super().setup(state)
        self._done = False

    def step(self, report: PeakReport) -> bool:
        if self._done:
            return False
        self._done = True
        changed = False
        for j, seq in self.state.jobs.items():
            changed |= self._plan_job(seq, self.state.plans[j],
                                      self.state.profile)
        return changed

    @staticmethod
    def _plan_job(seq: AccessSequence, plan: SchedulingPlan,
                  profile: MachineProfile) -> bool:
        changed = False
        # vDNN offloads the feature maps flowing through heavy layers:
        # tensors produced by OR consumed by a conv-like op in the forward
        # pass and reused much later (their backward consumer).
        heavy_io: set = set()
        for op in seq.operators:
            if op.name in HEAVY_OPS:
                heavy_io.update(op.inputs)
                heavy_io.update(op.outputs)
        min_gap = max(4, len(seq.operators) // 10)
        # vDNN's framework manages layer activations: the feature maps
        # flowing through its layers are freed after their last (backward)
        # use — but nothing else is (tensors inside a "layer" and optimizer
        # interim tensors are invisible to layer granularity; paper §II).
        last_use = seq.activity_analysis()
        for tid, spec in seq.tensors.items():
            if spec.kind is TensorKind.ACTIVATION and tid in heavy_io:
                plan.set_release(tid, last_use[tid])
                changed = True
        for tid, spec in seq.tensors.items():
            if spec.kind is not TensorKind.ACTIVATION or tid not in heavy_io:
                continue
            accs = seq.tensor_accesses(tid)
            tga = seq.tga(tid)
            if tga is None:
                continue
            tuas = [a for a in accs if a.access_type is AccessType.TUA]
            # feature map reused much later (backward): the vDNN candidates
            later = [a for a in tuas if a.op_idx > tga.op_idx + min_gap]
            if not later:
                continue
            first_fwd_use_end = (tuas[0].end_time if tuas else tga.end_time)
            back = later[-1]
            dur = profile.swap_time(spec.size_bytes)
            out_start = max(tga.end_time, first_fwd_use_end)
            # static prefetch trigger: one op before the backward consumer
            prefetch_op = max(back.op_idx - 1, tga.op_idx)
            in_start = seq.op_start[prefetch_op]
            if in_start <= out_start + dur:
                continue  # vDNN skips maps it cannot prefetch in time
            plan.add(ScheduleEvent(
                event_type=EventType.SWAP_OUT, tensor_id=tid,
                job_id=seq.job_id, trigger_op=tga.op_idx,
                delta=out_start - tga.end_time, start=out_start,
                end=out_start + dur, size_bytes=spec.size_bytes))
            plan.add(ScheduleEvent(
                event_type=EventType.SWAP_IN, tensor_id=tid,
                job_id=seq.job_id, trigger_op=prefetch_op, delta=0.0,
                start=in_start, end=in_start + dur,
                size_bytes=spec.size_bytes, target_op=back.op_idx))
            changed = True
        return changed


# ----------------------------------------------------------------------
# Capuchin (Peng et al., ASPLOS'20): passive profiling + candidate walk
# ----------------------------------------------------------------------
@dataclasses.dataclass
class _CapuchinAction:
    job_id: str
    mode: str                      # "swap" | "recompute"
    events: List[ScheduleEvent]


class PassiveProfilePass(PlanningPass):
    """Capuchin's observation epoch: one passive-mode iteration per job
    (counted into its overhead by the benchmarks), after which the eviction
    candidates and their swap-vs-recompute decisions are fixed — Capuchin
    schedules *within* one iteration from per-job profiles, so each job is
    profiled independently of the merged timeline."""

    name = "passive-profile"
    kind = "swap"

    def setup(self, state: PipelineState) -> None:
        super().setup(state)
        self._done = False

    def step(self, report: PeakReport) -> bool:
        if self._done:
            return False
        self._done = True
        actions: List[_CapuchinAction] = []
        for j, seq in self.state.jobs.items():
            actions.extend(_capuchin_decisions(
                seq, self.state.budget, self.state.profile))
        self.state.shared["capuchin_actions"] = actions
        for plan in self.state.plans.values():
            plan.passive_iterations = 1
        return True


def _capuchin_decisions(seq: AccessSequence, budget_bytes: int,
                        profile: MachineProfile) -> List["_CapuchinAction"]:
    """The Capuchin candidate walk: evict peak-contributing activations,
    largest first, until the predicted need is covered; per candidate,
    choose swap when the transfer hides under the compute between the
    eviction and the next access, else recompute by MSPS.  Decisions depend
    only on the passive profile, so they are fixed up front; the Pipeline
    applies them one per step through SwapPass/RecomputePass."""
    report = analyze([seq])
    cands: List[Tuple[str, int]] = []
    for sid, job, size in report.peak_tensors:
        spec = None
        for t in seq.tensors.values():
            if storage_of(t) == sid and t.kind is TensorKind.ACTIVATION:
                spec = t
                break
        if spec is not None:
            cands.append((spec.tid, size))

    actions: List[_CapuchinAction] = []
    freed = 0
    need = max(0, report.peak_bytes - budget_bytes)
    for tid, size in cands:
        if freed >= need:
            break
        spec = seq.tensors[tid]
        accs = seq.tensor_accesses(tid)
        tuas = [a for a in accs if a.access_type is AccessType.TUA]
        tga = seq.tga(tid)
        if tga is None or not tuas:
            continue
        # the idle window between the access before the peak and the next
        prev, nxt = tga, None
        for a in tuas:
            if prev.end_time <= report.peak_time <= a.time:
                nxt = a
                break
            prev = a
        if nxt is None:
            continue
        dur = profile.swap_time(spec.size_bytes)
        window = nxt.time - prev.end_time
        if window >= 2 * dur:
            # swap: out right after prev, in right before nxt ("free" —
            # hidden under compute)
            actions.append(_CapuchinAction(seq.job_id, "swap", [
                ScheduleEvent(
                    event_type=EventType.SWAP_OUT, tensor_id=tid,
                    job_id=seq.job_id, trigger_op=prev.op_idx, delta=0.0,
                    start=prev.end_time, end=prev.end_time + dur,
                    size_bytes=spec.size_bytes),
                ScheduleEvent(
                    event_type=EventType.SWAP_IN, tensor_id=tid,
                    job_id=seq.job_id, trigger_op=max(nxt.op_idx - 1, 0),
                    delta=0.0, start=nxt.time - dur, end=nxt.time,
                    size_bytes=spec.size_bytes, target_op=nxt.op_idx)]))
            freed += size
        else:
            # recompute if producer is cheap (high MSPS) and inputs persist
            producer = seq.operators[tga.op_idx]
            inputs_ok = all(
                seq.tensors[i].kind in PERSISTENT_KINDS
                or (seq.last_access(i)
                    and seq.last_access(i).end_time >= nxt.time)
                for i in producer.inputs if i in seq.tensors)
            if not inputs_ok:
                continue
            actions.append(_CapuchinAction(seq.job_id, "recompute", [
                ScheduleEvent(
                    event_type=EventType.RELEASE, tensor_id=tid,
                    job_id=seq.job_id, trigger_op=prev.op_idx, delta=0.0,
                    start=prev.end_time, end=prev.end_time,
                    size_bytes=spec.size_bytes),
                ScheduleEvent(
                    event_type=EventType.RECOMPUTE, tensor_id=tid,
                    job_id=seq.job_id, trigger_op=max(nxt.op_idx - 1, 0),
                    delta=0.0, start=nxt.time - producer.latency,
                    end=nxt.time, size_bytes=spec.size_bytes,
                    target_op=nxt.op_idx, recompute_ops=[tga.op_idx])]))
            freed += size
    return actions


def _capuchin_step(state: PipelineState, want: str) -> bool:
    """Apply the next prepared Capuchin action of the wanted mode."""
    actions = state.shared.get("capuchin_actions", [])
    key = f"capuchin_cursor_{want}"
    i = state.shared.get(key, 0)
    while i < len(actions):
        act = actions[i]
        i += 1
        if act.mode != want:
            continue
        state.shared[key] = i
        for ev in act.events:
            state.plans[act.job_id].add(ev)
        return True
    state.shared[key] = i
    return False


# ----------------------------------------------------------------------
# The Pipeline: Algorithm 3's convergence loop over ordered passes
# ----------------------------------------------------------------------
PassSpec = Union[PlanningPass, type]


class Pipeline:
    """Ordered passes under one peak-analysis convergence loop.

    Per iteration the first still-active pass whose ``gate`` admits the
    current report takes one greedy step; a pass whose step makes no change
    is retired.  Stops when no pass is eligible, when the iteration cap is
    hit, or when the average peak reduction over ``patience_window``
    iterations falls below ``min_improvement`` after ``patience_iters``
    iterations (paper Alg 3 line 4).
    """

    def __init__(self, passes: Sequence[PassSpec], *,
                 name: str = "pipeline",
                 cross_iteration: bool = False,
                 profile: Optional[MachineProfile] = None,
                 config: Optional[SchedulerConfig] = None,
                 free_at_last_use: bool = True,
                 passive_iterations: int = 0,
                 telemetry=None,
                 experience=None):
        self.pass_specs = list(passes)
        self.name = name
        self.cross_iteration = cross_iteration
        self.profile = profile or MachineProfile()
        self.config = config or SchedulerConfig()
        # evaluation semantics of the policy's host framework:
        # vDNN/vanilla platforms have no activity-analysis releases
        self.free_at_last_use = free_at_last_use
        self.passive_iterations = passive_iterations
        # measured-telemetry plane: a TelemetryHub here is handed to every
        # pass via state.shared["telemetry"], so swap windows are sized
        # from measured DMA bandwidth once samples exist (None = modeled
        # constants, byte-reproducible plans)
        self.telemetry = telemetry
        # experience plane: an ExperienceStore here (1) seeds each job's
        # plan from the store's best verified cached plan — Alg.-3
        # convergence then starts from prior-run experience instead of an
        # empty plan — and (2) hands stored DMA bandwidth to every
        # SwapPlanner via state.shared["experience"].  None (the default)
        # keeps cold planning byte-reproducible.
        self.experience = experience
        # per-job incremental window sweeps carried ACROSS replan_from
        # calls: a WindowSweep re-freezes itself whenever its
        # preconditions break (timeline version, safe point, prefix
        # events), so persisting it here just lets consecutive replans of
        # an unchanged job reuse the frozen prefix aggregates
        self._window_sweeps: Dict[str, WindowSweep] = {}

    def _instantiate(self) -> List[PlanningPass]:
        return [p() if isinstance(p, type) else p for p in self.pass_specs]

    # ------------------------------------------------------------------
    def plan(self, seqs: Sequence[AccessSequence],
             offsets: Optional[Dict[str, float]] = None) -> ScheduleResult:
        t0 = _time.perf_counter()
        cfg = self.config
        offsets = offsets or {}
        jobs = {s.job_id: s for s in seqs}
        plans = {j: SchedulingPlan(job_id=j) for j in jobs}
        budget = (cfg.memory_budget_bytes
                  if cfg.memory_budget_bytes is not None
                  else self.profile.device_memory_bytes)
        job_budgets = {j: b for j, b in
                       (cfg.per_job_budget_bytes or {}).items() if j in jobs}
        # warm boot (experience plane): seed each job's plan from the
        # store's best cached plan for this pipeline, REBASED onto the
        # current timeline and RE-VERIFIED against the job's current
        # budget inside lookup_plan — a failed verification (e.g. the
        # budget shrank) returns None and the job plans cold.  Seeded
        # plans carry a "warm-boot" provenance record; the convergence
        # loop below continues from them (SwapPlanner re-books their
        # channel events on setup).
        warm_booted: set = set()
        if self.experience is not None:
            for j, s in jobs.items():
                try:
                    cached = self.experience.lookup_plan(
                        s, self.name, job_budgets.get(j, budget),
                        profile=self.profile)
                except Exception:   # noqa: BLE001 - corrupt store: cold plan
                    cached = None
                if cached is not None:
                    plans[j] = cached
                    warm_booted.add(j)
        state = PipelineState(jobs=jobs, plans=plans, profile=self.profile,
                              config=cfg, offsets=dict(offsets),
                              budget=budget,
                              cross_iteration=self.cross_iteration,
                              job_budgets=job_budgets)
        if self.telemetry is not None:
            state.shared["telemetry"] = self.telemetry
        if self.experience is not None:
            state.shared["experience"] = self.experience
        passes = self._instantiate()
        for p in passes:
            p.setup(state)

        # vanilla normalizer (paper platform: no free-at-last-use)
        initial = analyze(seqs, plans=None, offsets=offsets,
                          free_at_last_use=False)
        # working reports use the policy's own platform semantics —
        # vanilla/vdnn frameworks have no activity-analysis releases
        falu = self.free_at_last_use

        def _score(rep: PeakReport) -> int:
            # convergence signal: the global peak PLUS any remaining
            # per-job slice violations — autoscale steps reduce a job's
            # solo peak without necessarily moving the merged peak, and
            # must not read as stagnation (0 extra when no arbiter split)
            return rep.peak_bytes + sum(
                over_budget_jobs(state, rep).values())

        report = analyze(seqs, plans=plans, offsets=offsets,
                         free_at_last_use=falu)
        history: List[int] = [_score(report)]
        active = [True] * len(passes)
        # a fully warm-booted job set whose verified cached plans already
        # respect the device budget and every per-job slice IS a converged
        # artifact (it was the END state of a prior convergence): adopt it
        # as-is instead of re-running Alg. 3 — this is what makes
        # time-to-first-feasible-plan collapse on recurring workloads
        if warm_booted and warm_booted == set(jobs) \
                and report.peak_bytes <= budget \
                and not over_budget_jobs(state, report):
            active = [False] * len(passes)
        steps: Dict[str, int] = {p.name: 0 for p in passes}
        iters = 0

        while any(active):
            if iters >= cfg.max_iterations:
                break
            # paper Alg 3 line 4: early stop on stagnation
            if iters > cfg.patience_iters and len(history) > cfg.patience_window:
                prev = history[-cfg.patience_window - 1]
                cur = history[-1]
                if prev > 0 and (prev - cur) / prev < cfg.min_improvement:
                    break
            idx = next((i for i, p in enumerate(passes)
                        if active[i] and p.gate(report)), None)
            if idx is None:
                break
            if passes[idx].step(report):
                steps[passes[idx].name] += 1
            else:
                active[idx] = False
            report = analyze(seqs, plans=plans, offsets=offsets,
                             free_at_last_use=falu)
            history.append(_score(report))
            iters += 1

        wall = _time.perf_counter() - t0
        for j in jobs:
            plans[j].vanilla_peak_bytes = initial.per_job_peak.get(j, 0)
            plans[j].planned_peak_bytes = report.per_job_peak.get(j, 0)
            plans[j].plan_wallclock_s = wall
            plans[j].budget_bytes = state.job_budgets.get(j, budget)
        # counts reflect the PLANS, not the pass bookkeeping: one per
        # distinct swapped tensor (seed semantics) / recompute event
        n_swaps = sum(len(p.swapped_tensors()) for p in plans.values())
        n_recs = sum(len(p.recomputes()) for p in plans.values())
        return ScheduleResult(
            plans=plans, initial_report=initial, final_report=report,
            iterations=iters, swaps_scheduled=n_swaps,
            recomputes_scheduled=n_recs, plan_wallclock_s=wall,
            pass_steps=steps)

    # ------------------------------------------------------------------
    def replan_from(self, seqs: Sequence[AccessSequence],
                    prior_plans: Dict[str, SchedulingPlan],
                    steps: Union[int, Dict[str, int]],
                    budgets: Optional[Dict[str, int]] = None
                    ) -> ScheduleResult:
        """Incremental replan for the REMAINDER of the current iteration
        (preemptive mid-iteration slice shrinking).

        ``steps[job]`` is the safe-point op the runtime will splice at
        (engine.find_safe_points); ``budgets`` the new per-job slices
        (default: the config's ``per_job_budget_bytes``).  Each returned
        plan is a copy of the prior plan extended with eager swap-outs
        placed strictly after the safe point — the prefix is byte-identical
        to the running plan by construction, so
        ``prior.splice(new, step) == new`` and the simulator/executor can
        adopt it mid-iteration via ``JobContext.set_plan`` without tearing
        the iteration.  Every plan carries a ``replan_from`` provenance
        record (safe-point op, old/new budget, events added).
        """
        t0 = _time.perf_counter()
        cfg = self.config
        jobs = {s.job_id: s for s in seqs}
        if isinstance(steps, int):
            steps = {j: steps for j in jobs}
        plans: Dict[str, SchedulingPlan] = {}
        prior_n: Dict[str, int] = {}
        for j in jobs:
            prior = prior_plans.get(j)
            plans[j] = prior.copy() if prior is not None \
                else SchedulingPlan(job_id=j)
            prior_n[j] = len(plans[j].events)
        budget = (cfg.memory_budget_bytes
                  if cfg.memory_budget_bytes is not None
                  else self.profile.device_memory_bytes)
        job_budgets = dict(budgets) if budgets else {
            j: b for j, b in (cfg.per_job_budget_bytes or {}).items()
            if j in jobs}
        state = PipelineState(jobs=jobs, plans=plans, profile=self.profile,
                              config=cfg, offsets={}, budget=budget,
                              cross_iteration=self.cross_iteration,
                              job_budgets=job_budgets)
        if self.telemetry is not None:
            state.shared["telemetry"] = self.telemetry
        if self.experience is not None:
            state.shared["experience"] = self.experience
        state.shared["replan_from_op"] = {j: op for j, op in steps.items()
                                          if j in jobs}
        # drop sweeps of jobs that no longer exist, keep live ones warm
        self._window_sweeps = {j: sw for j, sw in self._window_sweeps.items()
                               if j in jobs}
        state.shared["window_sweeps"] = self._window_sweeps
        initial = analyze(seqs, plans={j: prior_plans.get(j) for j in jobs
                                       if prior_plans.get(j) is not None},
                          free_at_last_use=self.free_at_last_use)
        p = PreemptiveReplanPass()
        p.setup(state)
        iters = 0
        n_steps = 0
        while iters < cfg.max_iterations and p.gate(None):
            if not p.step(None):
                break
            n_steps += 1
            iters += 1
        wall = _time.perf_counter() - t0
        final = analyze(seqs, plans=plans,
                        free_at_last_use=self.free_at_last_use)
        for j, plan in plans.items():
            old_budget = plan.budget_bytes
            plan.budget_bytes = job_budgets.get(j, old_budget)
            plan.planned_peak_bytes = final.per_job_peak.get(j, 0)
            plan.plan_wallclock_s = wall
            plan.provenance.append({
                "action": "replan_from", "op": steps.get(j),
                "from_budget_bytes": old_budget,
                "to_budget_bytes": plan.budget_bytes,
                "prior_events": prior_n[j],
                "added_events": len(plan.events) - prior_n[j]})
        n_swaps = sum(len(pl.swapped_tensors()) for pl in plans.values())
        n_recs = sum(len(pl.recomputes()) for pl in plans.values())
        return ScheduleResult(
            plans=plans, initial_report=initial, final_report=final,
            iterations=iters, swaps_scheduled=n_swaps,
            recomputes_scheduled=n_recs, plan_wallclock_s=wall,
            pass_steps={p.name: n_steps})


# ----------------------------------------------------------------------
# Policy registry: every planner in the repo, by name
# ----------------------------------------------------------------------
def _vanilla(profile=None, config=None) -> Pipeline:
    return Pipeline([], name="vanilla", profile=profile, config=config,
                    free_at_last_use=False)


def _vdnn(profile=None, config=None) -> Pipeline:
    return Pipeline([VdnnSwapPass], name="vdnn", profile=profile,
                    config=config, free_at_last_use=False)


def _capuchin(profile=None, config=None) -> Pipeline:
    return Pipeline([PassiveProfilePass(), SwapPass(style="capuchin"),
                     RecomputePass(style="capuchin")],
                    name="capuchin", profile=profile, config=config,
                    passive_iterations=1)


def _tensile(profile=None, config=None) -> Pipeline:
    return Pipeline([SwapPass(), RecomputePass()], name="tensile",
                    cross_iteration=True, profile=profile, config=config)


def _tensile_compressed(profile=None, config=None) -> Pipeline:
    return Pipeline([SwapPass(), CompressedOffloadPass(), RecomputePass()],
                    name="tensile+compressed-offload", cross_iteration=True,
                    profile=profile, config=config)


def _tensile_priority(profile=None, config=None) -> Pipeline:
    return Pipeline([PriorityPass(), RecomputePass()],
                    name="tensile+priority", cross_iteration=True,
                    profile=profile, config=config)


def _tensile_autoscale(profile=None, config=None) -> Pipeline:
    return Pipeline([SwapPass(), BudgetAutoscalePass(), RecomputePass()],
                    name="tensile+autoscale", cross_iteration=True,
                    profile=profile, config=config)


PIPELINES: Dict[str, Callable[..., Pipeline]] = {
    "vanilla": _vanilla,
    "vdnn": _vdnn,
    "capuchin": _capuchin,
    "tensile": _tensile,
    "tensile+compressed-offload": _tensile_compressed,
    "tensile+priority": _tensile_priority,
    "tensile+autoscale": _tensile_autoscale,
}


def build_pipeline(name: str,
                   profile: Optional[MachineProfile] = None,
                   config: Optional[SchedulerConfig] = None) -> Pipeline:
    try:
        factory = PIPELINES[name]
    except KeyError:
        raise KeyError(f"unknown pipeline {name!r}; "
                       f"known: {sorted(PIPELINES)}") from None
    return factory(profile=profile, config=config)
