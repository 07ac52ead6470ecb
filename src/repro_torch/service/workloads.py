"""Workloads for TENSILE: the train-step factories, and the registry that
resolves a ``JobSpec.workload`` reference to a payload.

A *payload* is the tuple ``(step_fn, params, opt_state, batch)`` that
``GlobalController`` captures and runs.  Resolution order (the JAX
package's ``service/workloads.py``):

1. ``spec.payload``, the in-process escape hatch, wins outright.
2. A name registered with :func:`register_workload`.
3. A ``"module:attr"`` import path to a factory with the same signature.

Factories take ``**spec.workload_params``; a caller that owns a device
(``GlobalController``) passes it as ``device`` to a factory that takes
one, unless the params name it, so a spec that crossed a daemon's inbox
runs where the daemon runs.  The builtin ``"mlp"`` workload
is ``make_mlp``: the JAX package's canonical smoke workload, a tanh MLP
with a mean-squared-error loss and one AdamW step.  Its weights and data
are numpy arrays (the caller's, e.g. the JAX package's drawn ones, or numpy
draws from ``seed``) moved onto the device by ``convert.tree_from_numpy``;
torch's RNG draws nothing.  The parameter tree is a list of ``{"b", "w"}``
dicts, whose leaves flatten in the reference's order.

Serving jobs (``spec.kind == "serve"``) resolve through a parallel
registry: a *serve factory* takes the spec's ``ServeParams`` and returns
``(serving_engine, requests)``.  The builtin ``"lm"`` serve workload,
``make_lm_serving``, builds both from the named (reduced) model config and
trace generator; a caller registers its own factory for another shape
(``register_serve_workload``).
"""
from __future__ import annotations

import importlib
import inspect
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..convert import tree_from_numpy
from ..optim.adam import adamw_init, adamw_step
from .jobspec import JobSpec

Payload = Tuple[Any, Any, Any, Any]
WorkloadFactory = Callable[..., Payload]
ServeFactory = Callable[..., Tuple[Any, Any]]

_REGISTRY: Dict[str, WorkloadFactory] = {}
_SERVE_REGISTRY: Dict[str, ServeFactory] = {}


def register_workload(name: str, factory: WorkloadFactory) -> None:
    """Register ``factory`` under ``name`` (overwrites an existing entry)."""
    if not name or ":" in name:
        raise ValueError(f"invalid workload name {name!r}")
    _REGISTRY[name] = factory


def registered_workloads() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _import_factory(spec: JobSpec, name: str, what: str):
    mod_name, _, attr = name.partition(":")
    try:
        return getattr(importlib.import_module(mod_name), attr)
    except (ImportError, AttributeError) as exc:
        raise ValueError(f"job {spec.job_id!r}: cannot import {what} "
                         f"{name!r}: {exc}") from exc


def _device_kwargs(factory: Callable, kwargs: Dict[str, Any],
                   device) -> Dict[str, Any]:
    """``kwargs`` with ``device`` added when the factory takes a
    ``device`` parameter and ``kwargs`` does not already name one."""
    if device is None or "device" in kwargs:
        return kwargs
    try:
        takes = "device" in inspect.signature(factory).parameters
    except (TypeError, ValueError):
        takes = False
    return dict(kwargs, device=device) if takes else kwargs


def resolve_workload(spec: JobSpec, device=None) -> Payload:
    """Resolve ``spec`` to ``(step_fn, params, opt_state, batch)``, on
    ``device`` where the factory takes one and the params name none.

    Raises ``ValueError`` when the spec names nothing resolvable."""
    if spec.payload is not None:
        return spec.payload  # type: ignore[return-value]
    if not spec.workload:
        raise ValueError(
            f"job {spec.job_id!r}: spec has neither payload nor workload")
    factory = _REGISTRY.get(spec.workload)
    if factory is None and ":" in spec.workload:
        factory = _import_factory(spec, spec.workload, "workload")
    if factory is None:
        raise ValueError(
            f"job {spec.job_id!r}: unknown workload {spec.workload!r} "
            f"(registered: {', '.join(registered_workloads()) or 'none'})")
    return factory(**_device_kwargs(factory, dict(spec.workload_params),
                                    device))


def register_serve_workload(name: str, factory: ServeFactory) -> None:
    """Register a serve factory: ``factory(serve_params) -> (engine,
    requests)``.  Overwrites an existing entry."""
    if not name or ":" in name:
        raise ValueError(f"invalid serve workload name {name!r}")
    _SERVE_REGISTRY[name] = factory


def registered_serve_workloads() -> Tuple[str, ...]:
    return tuple(sorted(_SERVE_REGISTRY))


def resolve_serve_workload(spec: JobSpec, device=None) -> Tuple[Any, Any]:
    """Resolve a ``kind="serve"`` spec to ``(serving_engine, requests)``,
    on ``device`` where the factory takes one; an unresolvable spec raises
    ``ValueError``."""
    if spec.kind != "serve":
        raise ValueError(f"job {spec.job_id!r}: not a serve spec")
    name = spec.workload or "lm"
    factory = _SERVE_REGISTRY.get(name)
    if factory is None and ":" in name:
        factory = _import_factory(spec, name, "serve workload")
    if factory is None:
        raise ValueError(
            f"job {spec.job_id!r}: unknown serve workload {name!r} "
            f"(registered: {', '.join(registered_serve_workloads()) or 'none'})")
    return factory(spec.serve, **_device_kwargs(factory, {}, device))


def make_lm_serving(sp, device=None) -> Tuple[Any, Any]:
    """Builtin ``"lm"`` serve workload: a ``ServingEngine`` over the named
    model config, reduced as in the JAX package, on ``device`` (default
    ``cuda``), and the named deterministic trace."""
    from ..serving.engine import ServingEngine
    from ..serving.traces import make_trace

    engine = ServingEngine(sp.arch, max_sequences=sp.max_sequences,
                           max_len=sp.prompt_len + sp.gen_len, seed=sp.seed,
                           device=device)
    requests = make_trace(sp.trace, sp.n_requests, seed=sp.seed,
                          prompt_len=sp.prompt_len, gen_len=sp.gen_len,
                          mean_gap=sp.mean_gap)
    return engine, requests

# size-class presets shared with the reference's scenario suite
MLP_SIZE_PRESETS = {
    "small": ((32, 64, 64, 8), 8),
    "medium": ((64, 128, 128, 8), 16),
    "large": ((64, 256, 256, 8), 16),
}


def mlp_numpy(sizes: Sequence[int], batch: int, seed: int = 0):
    """Weights ``N(0, 1) * 0.02`` and zero biases, inputs and targets
    ``N(0, 1)``, all float32 from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    params = [{"b": np.zeros(sizes[i + 1], np.float32),
               "w": (rng.standard_normal((sizes[i], sizes[i + 1]))
                     * 0.02).astype(np.float32)}
              for i in range(len(sizes) - 1)]
    x = rng.standard_normal((batch, sizes[0])).astype(np.float32)
    y = rng.standard_normal((batch, sizes[-1])).astype(np.float32)
    return params, (x, y)


def mlp_forward(params, x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, p in enumerate(params):
        h = h @ p["w"] + p["b"]
        if i < len(params) - 1:
            h = torch.tanh(h)
    return h


def mlp_train_step(params, opt_state, batch):
    """``(params, opt_state, (x, y)) -> (params, opt_state, loss)``, pure:
    the mean squared error's gradients by autograd, then ``adamw_step``
    with lr 1e-3."""
    x, y = batch
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = torch.mean(
            (mlp_forward(pytree.tree_unflatten(leaves, spec), x) - y) ** 2)
        grads = torch.autograd.grad(loss, leaves)
    new_params, new_opt = adamw_step(
        params, pytree.tree_unflatten(list(grads), spec), opt_state,
        lr=1e-3)
    return new_params, new_opt, loss.detach()


def make_mlp(sizes: Optional[Sequence[int]] = None,
             batch: Optional[int] = None, seed: int = 0,
             size: Optional[str] = None, *, params: Any = None,
             data: Any = None, device=None
             ) -> Tuple[Any, Any, Any, Tuple[torch.Tensor, torch.Tensor]]:
    """Tiny MLP + AdamW train step: ``(train_step, params, opt_state,
    (x, y))`` on ``device`` (default ``cuda``).

    Pass explicit ``sizes``/``batch`` or a ``size`` class name from
    :data:`MLP_SIZE_PRESETS`.  ``params`` (a list of ``{"b", "w"}`` numpy
    dicts) and ``data`` (numpy ``(x, y)``) default to ``mlp_numpy`` draws
    from ``seed``."""
    if size is not None:
        if size not in MLP_SIZE_PRESETS:
            raise ValueError(f"unknown mlp size class {size!r}")
        preset_sizes, preset_batch = MLP_SIZE_PRESETS[size]
        sizes = sizes or preset_sizes
        batch = batch or preset_batch
    sizes = list(sizes or (32, 64, 64, 8))
    batch = batch or 8
    if params is None or data is None:
        drawn_params, drawn_data = mlp_numpy(sizes, batch, seed)
        params = drawn_params if params is None else params
        data = drawn_data if data is None else data
    tparams = tree_from_numpy(params, device)
    tdata = tuple(tree_from_numpy(list(data), device))
    return mlp_train_step, tparams, adamw_init(tparams), tdata


register_workload("mlp", make_mlp)
register_serve_workload("lm", make_lm_serving)
