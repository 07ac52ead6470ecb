"""TENSILE decisions as a train-step policy: the counterpart of the JAX
package's ``core/jax_integration.py``.

The executor runs a plan event by event; a train step built by
``launch.steps.build_train_step`` takes the same decisions in the forms
autograd offers:

  * recompute decisions -> a ``torch.utils.checkpoint`` selective
    checkpointing policy over ``checkpoint_name``-tagged activations
    (``create_selective_checkpoint_contexts``: a tagged output whose name
    is kept is ``MUST_SAVE``, every other op ``PREFER_RECOMPUTE``; the
    model checkpoints each repeat of its block under it);
  * swap decisions on activations -> kept tensors that live in pinned host
    memory between the forward and the backward pass (``make_remat_policy(
    ..., offload=True)`` on a card; on the CPU they are saved, as the
    reference's CPU fallback saves them);
  * Opt-phase across-iteration swaps -> moments and master weights in
    pinned host memory between steps (``opt_state_placement``,
    ``TrainStepConfig.offload_opt_state``; the paper's Fig. 1(c)).

The model never calls ``checkpoint_name``, as the reference's model never
does.  A policy from ``plan_decisions`` names activations by shape tags
that no activation carries, so under it every activation inside a block
repeat is recomputed: the same step as ``cfg.remat == "block"``, bit for
bit.  ``backend_supports_memory_kinds`` has no counterpart: a card always
has pinned host memory.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from ..device import is_dtensor
from .access import AccessSequence, TensorKind
from .plan import EventType, MachineProfile, SchedulingPlan
from .scheduler import MemoryScheduler, SchedulerConfig


@dataclasses.dataclass(frozen=True)
class TensileDecisions:
    """Distilled plan for a train step."""
    remat_names: FrozenSet[str] = frozenset()     # recompute these activations
    offload_names: FrozenSet[str] = frozenset()   # host-offload these
    save_names: FrozenSet[str] = frozenset()      # keep these resident
    offload_opt_state: bool = False               # Opt-phase across-iteration
    offload_master: bool = False
    device_peak_estimate: int = 0
    host_bytes_estimate: int = 0

    def summary(self) -> str:
        return (f"remat={sorted(self.remat_names)} "
                f"offload={sorted(self.offload_names)} "
                f"opt_host={self.offload_opt_state} "
                f"master_host={self.offload_master}")


# ----------------------------------------------------------------------
@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


_checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))
TAG = torch.ops.repro_torch.checkpoint_name.default


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Tag ``x`` (a copy of it) with ``name`` for a remat policy: one op the
    policy sees, whose output it saves when the name is kept.  A DTensor
    is tagged on its local shard (DTensor has no rule for the op) and
    comes back with its placements."""
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(
            torch.ops.repro_torch.checkpoint_name(x.to_local(), name),
            x.device_mesh, x.placements, run_check=False)
    return torch.ops.repro_torch.checkpoint_name(x, name)


class RematPolicy:
    """A selective checkpointing policy: outputs of ``checkpoint_name``
    tagged with a name in ``keep`` are saved, everything else recomputed.
    Tags named in ``to_host`` are kept in pinned host memory between the
    forward and the backward pass when they lie on a card.  Call it as a
    policy function, or hand ``context_fn`` to
    ``torch.utils.checkpoint.checkpoint``."""

    def __init__(self, keep: FrozenSet[str],
                 to_host: FrozenSet[str] = frozenset()):
        self.keep = frozenset(keep)
        self.to_host = frozenset(to_host)

    def __call__(self, ctx, op, *args, **kwargs) -> CheckpointPolicy:
        if op is TAG and args[1] in self.keep:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    def context_fn(self):
        if not self.to_host:
            return create_selective_checkpoint_contexts(self)
        kept: List[torch.Tensor] = []
        return _Keep(self, kept), _Reuse(self, kept)


class _Keep(TorchDispatchMode):
    """The forward pass under a policy with host offload: each kept tag's
    output is kept, in pinned host memory when its name is offloaded and
    it lies on a card."""

    def __init__(self, policy: RematPolicy, kept: List[torch.Tensor]):
        super().__init__()
        self.policy, self.kept = policy, kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is TAG and args[1] in self.policy.keep:
            if args[1] in self.policy.to_host and out.is_cuda:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                self.kept.append(host.copy_(out, non_blocking=True))
            else:
                self.kept.append(out.detach())
        return out


class _Reuse(TorchDispatchMode):
    """The recompute pass: a kept tag returns what the forward pass kept
    (fetched back to the card from the host) instead of running again."""

    def __init__(self, policy: RematPolicy, kept: List[torch.Tensor]):
        super().__init__()
        self.policy, self.kept = policy, kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is TAG and args[1] in self.policy.keep:
            val = self.kept.pop(0)
            return val.to(args[0].device, non_blocking=True)
        return func(*args, **(kwargs or {}))


def make_remat_policy(decisions: TensileDecisions,
                      offload: bool = False) -> RematPolicy:
    """Checkpoint policy implementing the plan's keep/recompute/offload
    split: names in ``save_names`` stay resident, names in
    ``offload_names`` go to pinned host memory (with ``offload``, on a
    card) or stay resident, everything else is recomputed."""
    off = frozenset(decisions.offload_names)
    return RematPolicy(frozenset(decisions.save_names) | off,
                       off if offload else frozenset())


def opt_state_placement(tensor: torch.Tensor, *, host: bool) -> torch.Tensor:
    """An optimizer-state leaf where the plan keeps it between steps: in
    pinned host memory when ``host`` and the leaf lies on a card, else
    where it is (the Opt-phase across-iteration swap of paper Fig. 1(c)
    as a residency decision)."""
    if not host or not tensor.is_cuda:
        return tensor
    out = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    return out.copy_(tensor)


# ----------------------------------------------------------------------
def plan_decisions(seq: AccessSequence, plan: SchedulingPlan,
                   name_of_tensor: Optional[Dict[str, str]] = None,
                   ) -> TensileDecisions:
    """Summarize a planned schedule into train-step decisions.

    `name_of_tensor` maps captured tensor ids to checkpoint_name tags; when
    absent, decisions are expressed per tensor-kind (opt-state/master
    offload + biggest-activation names by shape signature).
    """
    remat, offload = set(), set()
    opt_host = False
    host_bytes = 0
    for ev in plan.events:
        spec = seq.tensors.get(ev.tensor_id)
        if spec is None:
            continue
        if ev.event_type is EventType.RECOMPUTE:
            tag = (name_of_tensor or {}).get(ev.tensor_id,
                                             _shape_tag(spec))
            remat.add(tag)
        elif ev.event_type is EventType.SWAP_OUT:
            if spec.kind in (TensorKind.OPT_STATE,) or spec.updates:
                opt_host = True
                host_bytes += spec.size_bytes
            else:
                tag = (name_of_tensor or {}).get(ev.tensor_id,
                                                 _shape_tag(spec))
                offload.add(tag)
                host_bytes += spec.size_bytes
    return TensileDecisions(
        remat_names=frozenset(remat), offload_names=frozenset(offload),
        offload_opt_state=opt_host,
        device_peak_estimate=plan.planned_peak_bytes,
        host_bytes_estimate=host_bytes)


def _shape_tag(spec) -> str:
    return f"{spec.kind.value}:{'x'.join(map(str, spec.shape))}:{spec.dtype}"


# ----------------------------------------------------------------------
def schedule_for_budget(seq: AccessSequence, budget_bytes: int,
                        profile: Optional[MachineProfile] = None,
                        ) -> TensileDecisions:
    """One-call entry: plan a captured step under a device-memory budget and
    return the train-step decisions."""
    sched = MemoryScheduler(
        profile or MachineProfile(),
        SchedulerConfig(memory_budget_bytes=budget_bytes))
    sched.register_job(seq)
    res = sched.schedule()
    return plan_decisions(seq, res.plans[seq.job_id])
