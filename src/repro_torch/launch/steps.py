"""Train, prefill and serve step builders.

* ``build_train_step(api, tcfg)`` returns
  ``(params, opt_state, batch) -> (params, opt_state, metrics)``: loss and
  gradients (with gradient accumulation over ``microbatches``), then
  AdamW with global-norm clipping.  The parameters of the module and the
  optimizer state are updated IN PLACE and returned (the JAX step donates
  them for the same effect).
* ``build_prefill_step(api)`` returns ``(params, batch) -> logits``.
* ``build_serve_step(api)`` returns
  ``(params, cache, batch, index) -> (logits, cache)``; the cache is
  updated in place.

PyTorch runs eagerly, so there is no jit; prefill and decode run under
``torch.inference_mode()``.  The port has no mesh, so there are no
sharding rules, and the TENSILE remat policies, host-offloaded optimizer
state and int8 gradient compression come with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..optim.adam import AdamState, adamw_init, adamw_update, global_norm


@dataclasses.dataclass
class TrainStepConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    grad_clip_norm: Optional[float] = 1.0
    grad_compression: Optional[str] = None      # None ("int8": not ported)
    remat_policy: Optional[Callable] = None     # not ported
    microbatches: int = 1                       # grad accumulation (peak/n)


def _grads(loss: torch.Tensor, named: Dict[str, torch.Tensor]):
    return dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


def build_train_step(api, tcfg: Optional[TrainStepConfig] = None):
    tcfg = tcfg or TrainStepConfig()
    if tcfg.grad_compression is not None:
        raise NotImplementedError(
            f"grad_compression={tcfg.grad_compression!r} arrives with the "
            f"training slice (int8 error-feedback compression)")
    if tcfg.remat_policy is not None:
        raise NotImplementedError(
            "TENSILE remat policies arrive with the training slice")

    def train_step(params, opt_state: AdamState, batch):
        named = dict(params.named_parameters())
        for p in named.values():
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                n_mb = tcfg.microbatches
                if n_mb > 1:
                    # gradient accumulation: activations shrink by n at the
                    # cost of an fp32 gradient accumulator
                    grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for k, p in named.items()}
                    loss = torch.zeros((), device=opt_state.step.device)
                    for i in range(n_mb):
                        mb = {k: x.reshape((n_mb, x.shape[0] // n_mb)
                                           + tuple(x.shape[1:]))[i]
                              for k, x in batch.items()}
                        lm = api.loss(params, mb)
                        for k, g in _grads(lm, named).items():
                            grads[k] += g.float()
                        loss = loss + lm.detach()
                    grads = {k: a / n_mb for k, a in grads.items()}
                    loss = loss / n_mb
                else:
                    loss = api.loss(params, batch)
                    grads = _grads(loss, named)
                    loss = loss.detach()
        finally:
            for p in named.values():
                p.requires_grad_(False)
        _, new_opt = adamw_update(
            named, grads, opt_state, lr=tcfg.learning_rate,
            weight_decay=tcfg.weight_decay,
            grad_clip_norm=tcfg.grad_clip_norm)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        return params, new_opt, metrics

    return train_step


def build_prefill_step(api):
    def prefill_step(params, batch):
        with torch.inference_mode():
            logits, _ = api.forward(params, batch)
        return logits

    return prefill_step


def build_serve_step(api):
    def serve_step(params, cache, batch, index):
        with torch.inference_mode():
            return api.decode(params, batch, cache, index)

    return serve_step


def opt_state_for(params, *, use_master: bool = False,
                  abstract: bool = False) -> AdamState:
    """AdamW state for a parameter module; ``abstract`` builds it on the
    ``meta`` device (shapes and dtypes, no storage)."""
    named = dict(params.named_parameters())
    if abstract:
        named = {k: torch.empty(p.shape, dtype=p.dtype, device="meta")
                 for k, p in named.items()}
    return adamw_init(named, use_master=use_master)
