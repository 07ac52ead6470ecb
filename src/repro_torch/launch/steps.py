"""Train, prefill and serve step builders.

* ``build_train_step(api, tcfg)`` returns
  ``(params, opt_state, batch) -> (params, opt_state, metrics)``: loss and
  gradients (with gradient accumulation over ``microbatches``, and each
  block repeat checkpointed under ``remat_policy``, TENSILE's decisions,
  ``core.integration.make_remat_policy``), optionally int8 error-feedback
  gradient compression (``optim.compression``), then AdamW with
  global-norm clipping.  The parameters of the module and the optimizer
  state are updated IN PLACE and returned (the JAX step donates them for
  the same effect).  With ``offload_opt_state`` the moments and master
  copies live in pinned host memory between steps (the paper's Fig. 1(c)
  across-iteration swap, which the reference's step makes on backends with
  memory spaces): the step moves any still on the card there, and AdamW
  fetches each leaf for its update.
* ``build_functional_train_step(api, tcfg)`` returns the same step as a
  pure function over a flat parameter dict:
  ``(params, opt_state, batch) -> (new_params, new_opt_state, metrics)``
  with new tensors out (``adamw_step``), the form TENSILE captures
  (``core.graph_capture.capture_train_step``) and executes.
* ``build_prefill_step(api)`` returns ``(params, batch) -> logits``.
* ``build_serve_step(api)`` returns
  ``(params, cache, batch, index) -> (logits, cache)``; the cache is
  updated in place.

PyTorch runs eagerly, so there is no jit; prefill and decode run under
``torch.inference_mode()``.  The port has no mesh, so there are no
sharding rules, and the compressed gradients are the reduced ones (the
reference's compressed collective waits for the mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.utils._pytree as pytree

from ..core.integration import opt_state_placement
from ..optim.adam import (AdamState, adamw_init, adamw_step, adamw_update,
                          global_norm)
from ..optim.compression import ef_compress_grads


@dataclasses.dataclass
class TrainStepConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    grad_clip_norm: Optional[float] = 1.0
    # fp32 master copies of bf16 parameters: the state the caller makes
    # with ``opt_state_for(params, use_master=True)``
    use_master: bool = False
    grad_compression: Optional[str] = None      # None | "int8"
    offload_opt_state: bool = False             # TENSILE across-iteration
    remat_policy: Optional[Callable] = None     # from TENSILE decisions
    microbatches: int = 1                       # grad accumulation (peak/n)


def _grads(loss: torch.Tensor, named: Dict[str, torch.Tensor]):
    """d loss / d each of ``named``.  A leaf the loss never reads gets
    zeros, as ``jax.grad`` gives it (whisper's cross-attention biases);
    a leaf it reads gets the same gradient as without that rule."""
    return dict(zip(named, torch.autograd.grad(
        loss, list(named.values()), allow_unused=True,
        materialize_grads=True)))


def build_train_step(api, tcfg: Optional[TrainStepConfig] = None):
    tcfg = tcfg or TrainStepConfig()
    if tcfg.grad_compression not in (None, "int8"):
        raise ValueError(f"grad_compression={tcfg.grad_compression!r}: "
                         f"None or 'int8'")

    def loss_of(params, batch):
        return api.loss(params, batch, remat_policy=tcfg.remat_policy)

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
                        lm = loss_of(params, mb)
                        for k, g in _grads(lm, named).items():
                            grads[k] += g.float()
                        loss = loss + lm.detach()
                    grads = {k: a / n_mb for k, a in grads.items()}
                    loss = loss / n_mb
                else:
                    loss = loss_of(params, batch)
                    grads = _grads(loss, named)
                    loss = loss.detach()
        finally:
            for p in named.values():
                p.requires_grad_(False)
        if tcfg.grad_compression == "int8":
            grads, opt_state = ef_compress_grads(grads, opt_state)
        if tcfg.offload_opt_state:
            opt_state = opt_state_to_host(opt_state)
        _, new_opt = adamw_update(
            named, grads, opt_state, lr=tcfg.learning_rate,
            weight_decay=tcfg.weight_decay,
            grad_clip_norm=tcfg.grad_clip_norm)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        return params, new_opt, metrics

    return train_step


class _LossOf(torch.nn.Module):
    """``api.loss`` as a module over ``lm``'s parameters, so
    ``torch.func.functional_call`` can run it on given tensors."""

    def __init__(self, api, lm: torch.nn.Module):
        super().__init__()
        self.api = api
        self.lm = lm

    def forward(self, batch):
        return self.api.loss(self.lm, batch)


def build_functional_train_step(api, tcfg: Optional[TrainStepConfig] = None):
    """The train step as a pure function of ``(params, opt_state, batch)``
    with ``params`` a flat dict of tensors keyed like
    ``dict(model.named_parameters())``: loss and gradients by autograd on
    detached copies of the parameters, then ``adamw_step``.  Nothing it is
    given is written; it returns new parameters, a new optimizer state and
    ``{"loss", "grad_norm"}``."""
    tcfg = tcfg or TrainStepConfig()
    if tcfg.microbatches != 1 or tcfg.grad_compression is not None \
            or tcfg.remat_policy is not None:
        raise NotImplementedError(
            "the functional train step takes one microbatch, no gradient "
            "compression and no remat policy")
    shell = _LossOf(api, api.shell())

    def train_step(params: Dict[str, torch.Tensor], opt_state: AdamState,
                   batch):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        with torch.enable_grad():
            loss = torch.func.functional_call(
                shell, {"lm." + k: v for k, v in leaves.items()}, (batch,))
            grads = _grads(loss, leaves)
        new_params, new_opt = adamw_step(
            params, grads, opt_state, lr=tcfg.learning_rate,
            weight_decay=tcfg.weight_decay,
            grad_clip_norm=tcfg.grad_clip_norm)
        return new_params, new_opt, {"loss": loss.detach(),
                                     "grad_norm": global_norm(grads)}

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


def opt_state_to_host(opt_state: AdamState) -> AdamState:
    """The state with its moments and master copies in pinned host memory
    (``opt_state_placement``): a leaf already off the card stays as it
    is; on the CPU nothing moves."""
    def place(tree):
        return {k: opt_state_placement(t, host=True) for k, t in tree.items()}
    master = place(opt_state.master) if opt_state.master != () else ()
    return opt_state._replace(mu=place(opt_state.mu), nu=place(opt_state.nu),
                              master=master)


def offloaded_bytes(opt_state: AdamState) -> int:
    """Bytes the TENSILE plan parks on the host between steps (moments and
    master copies)."""
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(
        (opt_state.mu, opt_state.nu, opt_state.master)))
