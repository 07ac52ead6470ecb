"""AdamW from scratch, with the JAX package's arithmetic: fp32 moments,
bias correction, decoupled weight decay, global-norm clipping and optional
fp32 master copies of bf16 parameters.

Parameters, gradients and moments are pytrees of tensors: the train step
passes flat dicts keyed by the parameter's dotted name
(``dict(model.named_parameters())``), the MLP workload a list of dicts.
``adamw_update`` and ``sgd_update`` write the new parameters, moments and
master copies IN PLACE (the JAX train step donates those buffers for the
same effect) and return them.  ``adamw_step`` is the pure form, as the JAX
``adamw_update``: same arithmetic, new tensors out, so a captured step has
outputs that alias its inputs by position.  ``ef`` holds the error-feedback
residual of int8 gradient compression (``optim.compression``).

Moments and master copies may live in pinned host memory between steps
(``core.integration.opt_state_placement``, the paper's Fig. 1(c)
across-iteration swap): ``adamw_update`` fetches each such leaf to its
parameter's device for the leaf's update, writes it back, and returns once
the host copies are written; the arithmetic runs on the same device either
way, so the result is the same bit for bit.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from ..device import is_dtensor

Tree = Mapping[str, torch.Tensor]


class AdamState(NamedTuple):
    step: torch.Tensor               # int32 scalar
    mu: Any                          # 1st moments, params' structure
    nu: Any                          # 2nd moments
    master: Any                      # fp32 masters or ()
    ef: Any = ()                     # fp32 error-feedback residual or ()


def adamw_init(params: Any, *, use_master: bool = False,
               grad_compression: bool = False) -> AdamState:
    leaves = pytree.tree_leaves(params)
    device = leaves[0].device if leaves else None

    def zeros(p):
        if is_dtensor(p):
            # zeros with its mesh and placements
            return torch.zeros_like(p.detach(), dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    mu = pytree.tree_map(zeros, params)
    nu = pytree.tree_map(zeros, params)
    master = (pytree.tree_map(lambda p: p.detach().float().clone(), params)
              if use_master else ())
    ef = pytree.tree_map(zeros, params) if grad_compression else ()
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu=mu, nu=nu, master=master, ef=ef)


def _prologue(grads: Any, state: AdamState, b1: float, b2: float,
              grad_clip_norm: Optional[float]):
    """The advanced step, the clip scale (or None) and the two bias
    corrections."""
    step = state.step + 1
    stepf = step.float()
    scale = None
    if grad_clip_norm is not None:
        gnorm = global_norm(grads)
        scale = torch.clamp(grad_clip_norm / (gnorm + 1e-12), max=1.0)
    return step, scale, 1.0 - b1 ** stepf, 1.0 - b2 ** stepf


def _leaf(p, g, m, v, pm, scale, bc1, bc2, lr, b1, b2, eps, weight_decay,
          scratch: bool = False):
    """One leaf's AdamW arithmetic in fp32: ``(new, m32, v32)``, with
    ``pm`` the fp32 master copy of ``p`` or None.  With ``scratch`` the
    fp32 moments ``m`` and ``v`` are copies that may be overwritten: the
    same operations run in their memory."""
    g32 = g.float()
    if scale is not None:
        g32 = g32 * scale
    if scratch:
        m32 = m.mul_(b1).add_((1 - b1) * g32)
        v32 = v.mul_(b2).add_((1 - b2) * g32 * g32)
    else:
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
    base = (p if pm is None else pm).float()
    new = base - lr * ((m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
                       + weight_decay * base)
    return new, m32, v32


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: AdamState, *,
                 lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip_norm: Optional[float] = None,
                 ) -> Tuple[Tree, AdamState]:
    """One AdamW step.  Updates ``params``, ``state.mu``, ``state.nu`` and
    ``state.master`` in place; returns ``(params, new_state)`` with the
    step advanced.  A moment or master leaf off its parameter's device
    (pinned host memory) is fetched for the leaf's update and written
    back."""
    step, scale, bc1, bc2 = _prologue(grads, state, b1, b2, grad_clip_norm)
    use_master = state.master != ()
    fetched = None
    for name, p in params.items():
        kept = [state.mu[name], state.nu[name]]
        if use_master:
            kept.append(state.master[name])
        m, v, pm = [t.to(p.device, non_blocking=True) for t in kept] + (
            [] if use_master else [None])
        if m is not kept[0]:
            fetched = p.device
        # a fetched moment is the leaf's scratch: no second copy on the card
        new, m32, v32 = _leaf(p, grads[name], m, v, pm, scale, bc1, bc2,
                              lr, b1, b2, eps, weight_decay,
                              scratch=m is not kept[0])
        for dst, val in zip(kept, (m32, v32, new)):
            dst.copy_(val, non_blocking=True)
        p.copy_(new)
    if fetched is not None:
        # the host copies are the state: complete before anyone reads them
        torch.cuda.current_stream(fetched).synchronize()
    return params, state._replace(step=step)


def adamw_step(params: Any, grads: Any, state: AdamState, *,
               lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 0.0,
               grad_clip_norm: Optional[float] = None,
               ) -> Tuple[Any, AdamState]:
    """One AdamW step as a pure function: the arithmetic of
    ``adamw_update``, returning new parameter, moment and master tensors
    in the structure of ``params`` and leaving the inputs untouched."""
    step, scale, bc1, bc2 = _prologue(grads, state, b1, b2, grad_clip_norm)
    use_master = state.master != ()
    leaves_p, spec = pytree.tree_flatten(params)
    leaves_pm = (pytree.tree_leaves(state.master) if use_master
                 else [None] * len(leaves_p))
    new_p, new_m, new_v, new_pm = [], [], [], []
    for p, g, m, v, pm in zip(leaves_p, pytree.tree_leaves(grads),
                              pytree.tree_leaves(state.mu),
                              pytree.tree_leaves(state.nu), leaves_pm):
        new, m32, v32 = _leaf(p, g, m, v, pm, scale, bc1, bc2, lr, b1, b2,
                              eps, weight_decay)
        new_m.append(m32.to(m.dtype))
        new_v.append(v32.to(v.dtype))
        if use_master:
            new_pm.append(new)
        new_p.append(new.to(p.dtype))
    master = pytree.tree_unflatten(new_pm, spec) if use_master else ()
    return pytree.tree_unflatten(new_p, spec), AdamState(
        step=step, mu=pytree.tree_unflatten(new_m, spec),
        nu=pytree.tree_unflatten(new_v, spec), master=master, ef=state.ef)


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of squares of ``x``; of a DTensor, its replicated value as a
    plain tensor (the partial sums reduced), so that every rank holds the
    same number."""
    s = torch.sum(torch.square(x.float()))
    if not is_dtensor(x):
        return s
    from torch.distributed.tensor import Replicate
    return s.redistribute(placements=[Replicate()] * s.device_mesh.ndim
                          ).to_local()


def global_norm(tree: Any) -> torch.Tensor:
    leaves = pytree.tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(_square_sum(x) for x in leaves))


@torch.no_grad()
def sgd_update(params: Tree, grads: Tree, lr: float) -> Tree:
    """``p - lr * g`` in fp32, written back into ``params`` in place."""
    for name, p in params.items():
        p.copy_(p.float() - lr * grads[name].float())
    return params
