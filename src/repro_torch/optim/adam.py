"""AdamW from scratch, with the JAX package's arithmetic: fp32 moments,
bias correction, decoupled weight decay, global-norm clipping and optional
fp32 master copies of bf16 parameters.

Parameters, gradients and moments are flat dicts of tensors keyed by the
parameter's dotted name (``dict(model.named_parameters())``).  Unlike the
pure JAX functions, ``adamw_update`` and ``sgd_update`` write the new
parameters, moments and master copies IN PLACE (the JAX train step donates
those buffers for the same effect) and return them.  The reference's
error-feedback residual (``ef``, for int8 grad compression) is not ported
yet.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch

Tree = Mapping[str, torch.Tensor]


class AdamState(NamedTuple):
    step: torch.Tensor               # int32 scalar
    mu: Dict[str, torch.Tensor]      # 1st moments
    nu: Dict[str, torch.Tensor]      # 2nd moments
    master: Union[Dict[str, torch.Tensor], tuple]   # fp32 masters or ()


def adamw_init(params: Tree, *, use_master: bool = False) -> AdamState:
    device = next(iter(params.values())).device if params else None
    mu = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          for k, p in params.items()}
    nu = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          for k, p in params.items()}
    master = ({k: p.detach().float().clone() for k, p in params.items()}
              if use_master else ())
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu=mu, nu=nu, master=master)


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: AdamState, *,
                 lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip_norm: Optional[float] = None,
                 ) -> Tuple[Tree, AdamState]:
    """One AdamW step.  Updates ``params``, ``state.mu``, ``state.nu`` and
    ``state.master`` in place; returns ``(params, new_state)`` with the
    step advanced."""
    step = state.step + 1
    stepf = step.float()
    scale = None
    if grad_clip_norm is not None:
        gnorm = global_norm(grads)
        scale = torch.clamp(grad_clip_norm / (gnorm + 1e-12), max=1.0)
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    use_master = state.master != ()
    for name, p in params.items():
        g32 = grads[name].float()
        if scale is not None:
            g32 = g32 * scale
        m, v = state.mu[name], state.nu[name]
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        base = (state.master[name] if use_master else p).float()
        new = base - lr * ((m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
                           + weight_decay * base)
        m.copy_(m32)
        v.copy_(v32)
        if use_master:
            state.master[name].copy_(new)
        p.copy_(new)
    return params, state._replace(step=step)


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = list(tree.values())
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


@torch.no_grad()
def sgd_update(params: Tree, grads: Tree, lr: float) -> Tree:
    """``p - lr * g`` in fp32, written back into ``params`` in place."""
    for name, p in params.items():
        p.copy_(p.float() - lr * grads[name].float())
    return params
