"""Weights and optimizer state from the JAX package into the port.

``params_from_jax`` takes the JAX engine's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``, with ``blocks`` stacked on axis 0)
and returns the port's module holding the same values, so both packages
compute the same function.  ``adam_state_from_jax`` does the same for the
reference's ``AdamState``.  Nothing here imports JAX: the caller converts.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

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
    state)``), on the model's device, keyed by parameter name.  Raises if a
    moment's key set or shape differs from the model's parameters."""
    if len(getattr(np_state, "ef", ())):
        raise NotImplementedError("error-feedback (grad compression) state "
                                  "is not ported yet")
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
    return AdamState(step=step, mu=tree(np_state.mu), nu=tree(np_state.nu),
                     master=master)
