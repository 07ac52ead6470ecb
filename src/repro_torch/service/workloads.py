"""Train-step workloads for TENSILE, as step functions over pytrees.

``make_mlp`` is the JAX package's canonical smoke workload
(``service/workloads.py``): a tanh MLP with a mean-squared-error loss and
one AdamW step.  Its weights and data are numpy arrays (the caller's, e.g.
the JAX package's drawn ones, or numpy draws from ``seed``) moved onto the
device by ``convert.tree_from_numpy``; torch's RNG draws nothing.  The
parameter tree is a list of ``{"b", "w"}`` dicts, whose leaves flatten in
the reference's order.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..convert import tree_from_numpy
from ..optim.adam import adamw_init, adamw_step

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
