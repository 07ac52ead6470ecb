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
  updated in place (``shard_cache`` places it under a mesh).

PyTorch runs eagerly, so there is no jit; prefill and decode run under
``torch.inference_mode()`` (a prefill under rules under ``no_grad``).

Each builder takes ``rules`` (``launch.sharding.MeshRules``), the
reference's second argument, as a keyword.  Under rules the parameters
are DTensors on the rules' mesh (``sharding.shard_params`` places a plain
module's leaves, in place, on the step's first call), the batch is
``Shard(0)`` over the data axes where they divide it, the model's
``constrain`` calls redistribute activations, and plain tensors the model
makes (positions, masks) count as replicated.  The gradients are
redistributed to their parameters' placements (the data-parallel
reduction), the clip norm is replicated before its square root, int8
compression quantizes the blocks of each whole leaf, as the reference's
reduced gradients, and AdamW updates the DTensor leaves in place.  The
train step's metrics are plain tensors, the same on every rank; the
prefill's logits stay a DTensor (``full_tensor()`` gathers them).  The
decode step under a mesh of more than one device places plain cache
leaves by ``api.cache_axes()`` (the sequence on ``kv_seq``, as the
reference shards it) and returns the cache as DTensors, written in place
on the rank whose sequence shard holds ``index``; its attention combines
the ranks' partial softmax sums (``models.attention``).  On a one-device
mesh the decode step runs on the local tensors of the parameters and of
the cache (which may be DTensors: the serving engine places it), which
are the whole ones, and returns the cache it was given.

With ``offload_opt_state`` under rules, on a mesh of any size, the (1, 1)
one included, the moments and master copies are ``HostShard``s between
steps, placed by ``opt_state_shardings(..., offload=True)``: each rank's
shard of the leaf in pinned host memory (the reference's ``pinned_host``
memory kind, under which XLA moves the shards), fetched by AdamW for the
leaf's update and written back.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.utils._pytree as pytree

from ..core.integration import opt_state_placement
from ..optim.adam import (AdamState, adamw_init, adamw_step, adamw_update,
                          global_norm)
from ..optim.compression import ef_compress_grads
from ..device import is_dtensor
from .sharding import (HostShard, MeshRules, Sharding, _is_sharding,
                       local_params, shard_params, use_rules)


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
    a leaf it reads gets the same gradient as without that rule.  A
    DTensor leaf's gradient is redistributed to the leaf's placements:
    the data-parallel reduction."""
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True, materialize_grads=True)
    return {k: g.redistribute(named[k].device_mesh, named[k].placements)
            if is_dtensor(g) else g for k, g in zip(named, grads)}


@contextlib.contextmanager
def _under(rules: Optional[MeshRules]):
    """The model's context under ``rules``: its ``constrain`` calls
    active, and plain tensors it makes taken as replicated."""
    if rules is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with use_rules(rules), implicit_replication():
        yield


def _sharded_batch(rules: Optional[MeshRules], batch):
    """``batch`` with each plain leaf distributed by ``batch_sharding``
    (every rank holds the same global batch)."""
    if rules is None:
        return batch
    shardings = rules.batch_sharding(batch)
    return {k: x if is_dtensor(x) else shardings[k].distribute(x)
            for k, x in batch.items()}


def _many_devices(rules: Optional[MeshRules]) -> bool:
    return rules is not None and rules.mesh.size() > 1


def build_train_step(api, tcfg: Optional[TrainStepConfig] = None, *,
                     rules: Optional[MeshRules] = None):
    tcfg = tcfg or TrainStepConfig()
    if tcfg.grad_compression not in (None, "int8"):
        raise ValueError(f"grad_compression={tcfg.grad_compression!r}: "
                         f"None or 'int8'")

    def loss_of(params, batch):
        return api.loss(params, batch, remat_policy=tcfg.remat_policy)

    def train_step(params, opt_state: AdamState, batch):
        if rules is not None:
            shard_params(params, rules)
        named = dict(params.named_parameters())
        for p in named.values():
            p.requires_grad_(True)
        try:
            # the backward recomputes checkpointed blocks: under the rules
            with torch.enable_grad(), _under(rules):
                n_mb = tcfg.microbatches
                if n_mb > 1:
                    # gradient accumulation: activations shrink by n at the
                    # cost of an fp32 gradient accumulator
                    grads = {k: torch.zeros_like(p.detach(),
                                                 dtype=torch.float32)
                             for k, p in named.items()}
                    loss = torch.zeros((), device=opt_state.step.device)
                    for i in range(n_mb):
                        mb = {k: x.reshape((n_mb, x.shape[0] // n_mb)
                                           + tuple(x.shape[1:]))[i]
                              for k, x in batch.items()}
                        lm = loss_of(params, _sharded_batch(rules, mb))
                        for k, g in _grads(lm, named).items():
                            grads[k] += g.float()
                        loss = loss + lm.detach()
                    grads = {k: a / n_mb for k, a in grads.items()}
                    loss = loss / n_mb
                else:
                    loss = loss_of(params, _sharded_batch(rules, batch))
                    grads = _grads(loss, named)
                    loss = loss.detach()
        finally:
            for p in named.values():
                p.requires_grad_(False)
        if tcfg.grad_compression == "int8":
            grads, opt_state = ef_compress_grads(grads, opt_state)
        if tcfg.offload_opt_state:
            shardings = None if rules is None else opt_state_shardings(
                rules, {k: Sharding.of(p) for k, p in named.items()},
                use_master=opt_state.master != (), offload=True)
            opt_state = opt_state_to_host(opt_state, shardings)
        with _under(rules):
            _, new_opt = adamw_update(
                named, grads, opt_state, lr=tcfg.learning_rate,
                weight_decay=tcfg.weight_decay,
                grad_clip_norm=tcfg.grad_clip_norm)
        if is_dtensor(loss):
            loss = loss.full_tensor()
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


def build_prefill_step(api, *, rules: Optional[MeshRules] = None):
    def prefill_step(params, batch):
        if rules is not None:
            shard_params(params, rules)
        # a DTensor's views cannot be made in inference mode
        with (torch.inference_mode() if rules is None else torch.no_grad()
              ), _under(rules):
            logits, _ = api.forward(params, _sharded_batch(rules, batch))
        return logits

    return prefill_step


def shard_cache(api, rules: MeshRules, cache):
    """``cache`` with each plain leaf distributed by
    ``rules.shardings_for(api.cache_axes(), cache)`` (every rank holds
    the same values); DTensor leaves stay as they are."""
    shardings = rules.shardings_for(api.cache_axes(), cache)
    return pytree.tree_map(
        lambda t, sh: t if is_dtensor(t) else sh.distribute(t), cache,
        shardings)


def build_serve_step(api, *, rules: Optional[MeshRules] = None):
    if not _many_devices(rules):
        shell = api.shell() if rules is not None else None

        def serve_step(params, cache, batch, index):
            if shell is None:
                with torch.inference_mode():
                    return api.decode(params, batch, cache, index)
            params = local_params(params, shell)
            local = pytree.tree_map(
                lambda t: t.to_local() if is_dtensor(t) else t, cache)
            with torch.inference_mode():
                logits, _ = api.decode(params, batch, local, index)
            return logits, cache

        return serve_step

    def sharded_serve_step(params, cache, batch, index):
        shard_params(params, rules)
        cache = shard_cache(api, rules, cache)
        # a DTensor's views cannot be made in inference mode
        with torch.no_grad(), _under(rules):
            return api.decode(params, _sharded_batch(rules, batch), cache,
                              index)

    return sharded_serve_step


def opt_state_for(params, *, use_master: bool = False,
                  abstract: bool = False) -> AdamState:
    """AdamW state for a parameter module; ``abstract`` builds it on the
    ``meta`` device (shapes and dtypes, no storage)."""
    named = dict(params.named_parameters())
    if abstract:
        named = {k: _meta_like(p) for k, p in named.items()}
    return adamw_init(named, use_master=use_master)


def _meta_like(p: torch.Tensor) -> torch.Tensor:
    """A ``meta`` tensor of ``p``'s shape and dtype; a DTensor keeps its
    mesh and placements."""
    if is_dtensor(p):
        from torch.distributed.tensor import DTensor
        local = torch.empty(p.to_local().shape, dtype=p.dtype,
                            device="meta")
        return DTensor.from_local(local, p.device_mesh, p.placements,
                                  run_check=False, shape=p.shape,
                                  stride=p.stride())
    return torch.empty(p.shape, dtype=p.dtype, device="meta")


def opt_state_shardings(rules: MeshRules, param_shardings, *,
                        use_master: bool = False,
                        offload: bool = False) -> AdamState:
    """The reference's ``opt_state_shardings``: the moments (and master
    copies) mirror ``param_shardings`` (a tree of ``Sharding``s, such as
    ``rules.shardings_for(axes, params)`` or ``Sharding.of`` each DTensor
    parameter), of memory kind ``"pinned_host"`` with ``offload``: the
    TENSILE across-iteration decision.  ``step`` is replicated."""
    kind = "pinned_host" if offload else "device"

    def like():
        return pytree.tree_map(lambda s: s.with_memory_kind(kind),
                               param_shardings, is_leaf=_is_sharding)
    return AdamState(step=rules.replicated(), mu=like(), nu=like(),
                     master=like() if use_master else ())


def opt_state_to_host(opt_state: AdamState,
                      shardings: Optional[AdamState] = None) -> AdamState:
    """The state with its moments and master copies in host memory between
    steps.  A DTensor or ``HostShard`` leaf becomes a ``HostShard`` placed
    by ``shardings`` (``opt_state_shardings(..., offload=True)``; without
    them, by its own placements); one already so placed stays as it is.
    A plain leaf on a card moves to pinned host memory
    (``opt_state_placement``); on the CPU it stays where it is."""
    def place(name, tree):
        sh = None if shardings is None else getattr(shardings, name)

        def leaf(k, t):
            if is_dtensor(t) or isinstance(t, HostShard):
                s = Sharding.of(t) if sh is None else sh[k]
                return s.with_memory_kind("pinned_host").distribute(t)
            return opt_state_placement(t, host=True)
        return {k: leaf(k, t) for k, t in tree.items()}
    master = place("master", opt_state.master) \
        if opt_state.master != () else ()
    return opt_state._replace(mu=place("mu", opt_state.mu),
                              nu=place("nu", opt_state.nu), master=master)


def offloaded_bytes(opt_state: AdamState) -> int:
    """Bytes the TENSILE plan parks on the host between steps (moments and
    master copies), each leaf by its global shape, as the reference counts
    them: a ``HostShard`` as the whole tensor it is a shard of."""
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(
        (opt_state.mu, opt_state.nu, opt_state.master)))
