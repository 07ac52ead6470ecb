"""Weights and optimizer state from the JAX package into the port.

``params_from_jax`` takes the JAX engine's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``, with ``blocks`` stacked on axis 0)
and returns the port's module holding the same values, so both packages
compute the same function.  ``adam_state_from_jax`` does the same for the
reference's ``AdamState``, and ``latency_mlp_from_jax`` for the weights of
the reference's cold-start ``LatencyMLP``.  ``tree_from_numpy`` moves any pytree of numpy
arrays (the MLP workload's weights and data) onto a device.  Nothing here
imports JAX: the caller converts.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.cost_model import LatencyMLP
from .device import resolve_device
from .models.transformer import TransformerLM
from .optim.adam import AdamState


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bfloat16: reinterpret
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def tree_from_numpy(np_tree: Any, device=None) -> Any:
    """The same pytree (dicts, lists, tuples) with every numpy leaf as a
    tensor of its dtype on ``device`` (default ``cuda``)."""
    import torch.utils._pytree as pytree
    device = resolve_device(device)
    return pytree.tree_map(lambda a: _tensor(a).to(device), np_tree)


def params_from_jax(np_tree: Dict[str, Any], cfg, device=None
                    ) -> TransformerLM:
    """A :class:`TransformerLM` for ``cfg`` whose parameters are the arrays
    of ``np_tree``, placed on ``device`` (default ``cuda``).  Raises if a
    key is missing or extra, or a shape differs."""
    device = resolve_device(device)
    model = TransformerLM(cfg, device="meta")
    state = {k: _tensor(v).to(device) for k, v in _flatten(np_tree).items()}
    model.load_state_dict(state, strict=True, assign=True)
    for p in model.parameters():
        p.requires_grad_(False)
    return model


def adam_state_from_jax(np_state, model: TransformerLM) -> AdamState:
    """The port's :class:`AdamState` for ``model`` holding the values of the
    reference's ``AdamState`` given as numpy (``jax.tree.map(np.asarray,
    state)``), on the model's device, keyed by parameter name; its
    error-feedback residual ``ef`` comes across too.  Raises if a moment's
    key set or shape differs from the model's parameters."""
    named = dict(model.named_parameters())
    device = next(iter(named.values())).device

    def tree(t) -> Dict[str, torch.Tensor]:
        flat = {k: _tensor(v).to(device) for k, v in _flatten(t).items()}
        if set(flat) != set(named):
            raise KeyError(f"state keys differ from the model's: "
                           f"{sorted(set(flat) ^ set(named))}")
        for k, v in flat.items():
            if v.shape != named[k].shape:
                raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                                 f"{tuple(named[k].shape)}")
        return flat

    master = tree(np_state.master) if len(np_state.master) else ()
    step = torch.tensor(int(np.asarray(np_state.step)), dtype=torch.int32,
                        device=device)
    ef = getattr(np_state, "ef", ())
    return AdamState(step=step, mu=tree(np_state.mu), nu=tree(np_state.nu),
                     master=master, ef=tree(ef) if len(ef) else ())


LATENCY_MLP_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


def latency_mlp_from_jax(params: Dict[str, Any], device=None) -> LatencyMLP:
    """A :class:`LatencyMLP` on ``device`` (default ``cuda``) holding the
    reference's ``LatencyMLP.params`` given as numpy (``{w1, b1, w2, b2,
    w3, b3}``); its hidden width is ``w1``'s.  Raises if a key is missing
    or extra, or a shape differs."""
    if set(params) != set(LATENCY_MLP_KEYS):
        raise KeyError(f"LatencyMLP keys differ: "
                       f"{sorted(set(params) ^ set(LATENCY_MLP_KEYS))}")
    mlp = LatencyMLP(hidden=int(np.shape(params["w1"])[1]), device=device)
    with torch.no_grad():
        for k in LATENCY_MLP_KEYS:
            dst = getattr(mlp, k)
            src = _tensor(params[k]).to(dtype=dst.dtype)
            if src.shape != dst.shape:
                raise ValueError(f"{k}: shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
    return mlp
