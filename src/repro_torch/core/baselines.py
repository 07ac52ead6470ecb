"""Baseline planners reproduced for the paper's comparisons (§V-A).

All three baselines are now *pass configurations* over the same pipeline
engine that drives TENSILE (see ``passes.PIPELINES``), so the comparison
isolates the scheduling policy exactly as the paper argues ("what we want to
compare is the scheduling algorithm itself ... run on the same platform"):

* **vanilla** — ``Pipeline([])``: no scheduling, free-at-last-use only (the
  normalizer for all metrics; VMP / VTC in the paper).
* **vDNN_conv** (Rhu et al., MICRO'16) — ``Pipeline([VdnnSwapPass])``:
  *layer* granularity, static prefetch, no recomputation, no Opt-phase
  events, single-workload design.
* **Capuchin** (Peng et al., ASPLOS'20) — ``Pipeline([PassiveProfilePass,
  SwapPass(style="capuchin"), RecomputePass(style="capuchin")])``: *tensor*
  granularity after one passive observation iteration (counted into its
  overhead), swap when the transfer hides under compute, recompute (by MSPS)
  otherwise.  Within-iteration only: updated parameters and optimizer state
  are never scheduled, so cross-iteration prefetch is impossible (the gap
  TENSILE closes).

This module keeps the seed's functional entry points as thin wrappers so
existing callers and benchmarks are unaffected.

A copy of the JAX package's ``core/baselines.py`` (which imports no JAX),
kept in step with it; the port's tests hold the two to the same
results.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .access import AccessSequence
from .passes import HEAVY_OPS, SchedulerConfig, build_pipeline
from .plan import MachineProfile, SchedulingPlan

__all__ = ["HEAVY_OPS", "CapuchinResult", "capuchin_plan", "vanilla_plan",
           "vdnn_conv_plan"]


def vanilla_plan(seq: AccessSequence) -> SchedulingPlan:
    return build_pipeline("vanilla").plan([seq]).plans[seq.job_id]


def vdnn_conv_plan(seq: AccessSequence,
                   profile: Optional[MachineProfile] = None) -> SchedulingPlan:
    """vDNN_conv: swap out every heavy-layer forward feature map right after
    the layer finishes; swap it back when the op *before* its backward
    consumer starts (static one-layer lookahead prefetch)."""
    pipe = build_pipeline("vdnn", profile=profile)
    return pipe.plan([seq]).plans[seq.job_id]


@dataclasses.dataclass
class CapuchinResult:
    plan: SchedulingPlan
    passive_iterations: int = 1   # observation epoch (passive mode)


def capuchin_plan(seq: AccessSequence,
                  budget_bytes: int,
                  profile: Optional[MachineProfile] = None) -> CapuchinResult:
    """Capuchin: after passive observation, evict peak-contributing tensors;
    choose swap when the transfer hides under the compute between the
    eviction and the next access, else recompute by MSPS.  Schedules only
    within one iteration and only F/B-phase tensors."""
    pipe = build_pipeline(
        "capuchin", profile=profile,
        config=SchedulerConfig(memory_budget_bytes=budget_bytes))
    plan = pipe.plan([seq]).plans[seq.job_id]
    return CapuchinResult(plan=plan,
                          passive_iterations=max(plan.passive_iterations, 1))
