"""Weights from the JAX package into the port.

``params_from_jax`` takes the JAX engine's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``, with ``blocks`` stacked on axis 0)
and returns the port's module holding the same values, so both packages
compute the same function.  Nothing here imports JAX: the caller converts.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device
from .models.transformer import TransformerLM


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
