"""Serve step builder.

`build_serve_step` returns (params, cache, batch, index) -> (logits, cache).
PyTorch runs eagerly, so there is no jit; the step runs under
``torch.inference_mode()`` and updates the cache in place (the JAX step
donates the cache for the same effect).  No sharding rules in this slice.
"""
from __future__ import annotations

import torch


def build_serve_step(api):
    def serve_step(params, cache, batch, index):
        with torch.inference_mode():
            return api.decode(params, batch, cache, index)

    return serve_step
