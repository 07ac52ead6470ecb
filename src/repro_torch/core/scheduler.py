"""Memory Scheduler front-end (paper §IV-F, Algorithm 3) + plan updating
(§IV-E).

The convergence loop itself — greedy swap scheduling until no tensor can be
swapped, then MSPS-ranked recomputation while the predicted peak still
exceeds the budget, with the paper's patience/min-improvement stopping rule
— lives in ``passes.Pipeline``; the TENSILE policy is the pass configuration
``Pipeline([SwapPass, RecomputePass], cross_iteration=True)``.  This module
keeps the *runtime* responsibilities: the job registry, EWMA latency
correction, and the drift-triggered replan decision.

Plan updating: the Executor keeps reporting measured operator latencies; when
the summed latency drifts by more than `update_threshold` relative to the
sum used for the last plan, the scheduler rebuilds the Tensor Access Sequence
(EWMA-corrected latencies) and replans from scratch (§IV-E).

A copy of the JAX package's ``core/scheduler.py`` (which imports no JAX),
kept in step with it; the port's tests hold the two to the same
results.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from .access import AccessSequence
from .passes import (Pipeline, ScheduleResult, SchedulerConfig,
                     build_pipeline)
from .plan import MachineProfile, SchedulingPlan

__all__ = ["MemoryScheduler", "ScheduleResult", "SchedulerConfig",
           "schedule_single"]


class MemoryScheduler:
    """Global scheduler over all registered jobs (paper Fig. 3)."""

    def __init__(self, profile: Optional[MachineProfile] = None,
                 config: Optional[SchedulerConfig] = None,
                 pipeline: Optional[Pipeline] = None,
                 experience=None):
        self.profile = profile or MachineProfile()
        self.config = config or SchedulerConfig()
        # the planning policy; defaults to the paper's TENSILE pipeline but
        # any registered pipeline (or a custom pass list) drops in
        self.pipeline = pipeline or build_pipeline(
            "tensile", profile=self.profile, config=self.config)
        # experience plane: an ExperienceStore makes `schedule` consult
        # the per-fingerprint plan cache (verified warm starts) and seeds
        # swap windows from persisted bandwidth — see passes.Pipeline
        if experience is not None and self.pipeline.experience is None:
            self.pipeline.experience = experience
        self.jobs: Dict[str, AccessSequence] = {}
        self.offsets: Dict[str, float] = {}
        self.priorities: Dict[str, float] = {}
        # construction-time config values are the caller's: they are
        # restored (not clobbered) whenever a replan has no arbiter split
        # or a job no registered priority
        self._static_budgets = (dict(self.config.per_job_budget_bytes)
                                if self.config.per_job_budget_bytes
                                else None)
        self._static_priorities = dict(self.config.job_priorities or {})
        # latency sums used for the last plan, per job (drift detection)
        self._plan_latency_sum: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def register_job(self, seq: AccessSequence, offset: float = 0.0,
                     priority: Optional[float] = None) -> None:
        self.jobs[seq.job_id] = seq
        self.offsets[seq.job_id] = offset
        if priority is not None:
            self.priorities[seq.job_id] = priority
        self._plan_latency_sum[seq.job_id] = sum(
            op.latency for op in seq.operators)

    def priority_of(self, job_id: str) -> float:
        """Effective priority: registered value, else the caller's
        construction-time config, else 1.0."""
        return self.priorities.get(
            job_id, self._static_priorities.get(job_id, 1.0))

    def remove_job(self, job_id: str) -> None:
        self.jobs.pop(job_id, None)
        self.offsets.pop(job_id, None)
        self.priorities.pop(job_id, None)
        self._plan_latency_sum.pop(job_id, None)

    # ------------------------------------------------------------------
    def update_latencies(self, job_id: str, measured: Sequence[float]) -> bool:
        """EWMA-correct a job's operator latencies with runtime measurements;
        returns True if the drift exceeds the replan threshold (§IV-E)."""
        seq = self.jobs[job_id]
        a = self.config.ewma_alpha
        new = [a * m + (1 - a) * op.latency
               for m, op in zip(measured, seq.operators)]
        seq.set_latencies(new)
        s_old = self._plan_latency_sum.get(job_id, 0.0)
        s_new = sum(new)
        if s_old <= 0:
            return True
        return abs(s_new - s_old) / s_old > self.config.update_threshold

    def update_latencies_from_hub(self, job_id: str, hub) -> bool:
        """Hub-fed §IV-E correction (the measured-telemetry plane): fold
        the TelemetryHub's EWMA-corrected measured latencies into the
        job's sequence, and judge the replan decision by the HUB's drift
        ratio against the latency sum the current plan was built from —
        drift detection no longer lives in scheduler-private EWMA deltas.
        Ops the hub has no sample for yet keep their modeled latency
        (cold-start blending)."""
        if job_id not in self.jobs:
            return False
        seq = self.jobs[job_id]
        measured = hub.op_latencies(job_id)
        if not measured:
            return False
        a = self.config.ewma_alpha
        new = [a * measured[i] + (1 - a) * op.latency if i in measured
               else op.latency
               for i, op in enumerate(seq.operators)]
        seq.set_latencies(new)
        s_old = self._plan_latency_sum.get(job_id, 0.0)
        if s_old <= 0:
            return True
        return hub.drift_ratio(job_id, s_old) > self.config.update_threshold

    # ------------------------------------------------------------------
    def schedule(self, job_ids: Optional[Sequence[str]] = None,
                 budgets: Optional[Dict[str, int]] = None) -> ScheduleResult:
        """One pipeline run over the merged timeline of the given (default:
        all) registered jobs.

        `budgets` are the BudgetArbiter's per-job byte assignments for this
        replan; they (and the registered priorities) are published into the
        shared SchedulerConfig so budget-aware passes (PriorityPass,
        BudgetAutoscalePass) plan against the arbiter split instead of the
        full device.  Both change across replans — budget is an *input* of
        a plan, not a constant of the scheduler."""
        ids = list(job_ids) if job_ids is not None else list(self.jobs)
        seqs = [self.jobs[j] for j in ids]
        # registered priorities overlay construction-time config ones
        self.config.job_priorities = {
            j: self.priorities.get(j, self._static_priorities.get(j, 1.0))
            for j in ids}
        # rebuilt every replan — a replan without an arbiter split must not
        # re-enforce a previous split's stale slices, but it does restore
        # any static per-job budgets the caller configured up front
        self.config.per_job_budget_bytes = (
            {j: budgets[j] for j in ids if j in budgets}
            if budgets is not None
            else (dict(self._static_budgets)
                  if self._static_budgets else None))
        result = self.pipeline.plan(
            seqs, offsets={j: self.offsets[j] for j in ids})
        for j in ids:
            self._plan_latency_sum[j] = sum(
                op.latency for op in self.jobs[j].operators)
        return result

    # ------------------------------------------------------------------
    def replan_from(self, job_id: str, prior_plan: "SchedulingPlan",
                    step: int, budget_bytes: int) -> ScheduleResult:
        """Incremental remainder replan for one job against a shrunken
        slice (preemptive arbitration): delegates to
        ``Pipeline.replan_from`` with the job's registered sequence.  The
        returned plan extends ``prior_plan`` with eager swap-outs strictly
        after safe-point op ``step``, so the controller can hot-swap it
        into the running executor at that safe point."""
        seq = self.jobs[job_id]
        return self.pipeline.replan_from(
            [seq], {job_id: prior_plan}, {job_id: step},
            budgets={job_id: budget_bytes})


def schedule_single(seq: AccessSequence,
                    profile: Optional[MachineProfile] = None,
                    budget_bytes: Optional[int] = None,
                    max_swap_ratio: float = 1.0,
                    pipeline_name: str = "tensile") -> ScheduleResult:
    """Convenience one-job entry point (paper §V-B single-workload setup:
    MSR limit 100 %)."""
    profile = profile or MachineProfile()
    config = SchedulerConfig(memory_budget_bytes=budget_bytes,
                             max_swap_ratio=max_swap_ratio)
    sched = MemoryScheduler(
        profile=profile, config=config,
        pipeline=build_pipeline(pipeline_name, profile=profile,
                                config=config))
    sched.register_job(seq)
    return sched.schedule()
