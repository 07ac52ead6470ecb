"""Int8 block-quantized gradients with error feedback (the residual is
carried to the next step, Seide et al. 2014 / EF-SGD): the JAX package's
``optim/compression.py`` with the same arithmetic, bit for bit.

``ef_compress_grads`` is the train-step integration: quantize/dequantize
with error feedback applied to the gradients.  The port has no mesh, so
the compressed collective (the reference's ``compressed_psum_mean``) is
not here; the bytes a compressed exchange would put on a link are
``wire_bytes_ratio`` of the plain ones.  This is plain torch, as the
reference's is plain ``jnp``: 2048-element blocks with one fp32 scale
each, not the 512-element rows of ``kernels/offload_quant``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

BLOCK = 2048


def _quant(x: torch.Tensor):
    flat = x.reshape(-1)
    pad = -flat.numel() % BLOCK
    blocks = F.pad(flat, (0, pad)).reshape(-1, BLOCK)
    # divided by a tensor: on a card PyTorch divides by a Python number as
    # a product with its reciprocal, which is not the quotient's rounding
    scale = blocks.abs().amax(dim=-1, keepdim=True) / torch.full(
        (), 127.0, device=x.device)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def _dequant(q, scale, pad, shape, dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


def quantize_dequantize(x: torch.Tensor) -> torch.Tensor:
    q, s, pad = _quant(x.float())
    return _dequant(q, s, pad, x.shape, x.dtype)


@torch.no_grad()
def ef_compress_grads(grads: Any, opt_state) -> Tuple[Any, Any]:
    """Error-feedback int8 compression over the gradient pytree: each
    gradient plus its residual, quantized and dequantized; the residual
    becomes what that lost.  The residual lives in ``opt_state.ef`` (create
    the state with ``adamw_init(..., grad_compression=True)``) and is
    written in place, as the train step writes the moments; with no
    residual a zero one is made.  Returns the new gradients (new tensors)
    and the state holding the residual."""
    fresh = opt_state.ef == ()
    residual = pytree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads) if fresh else opt_state.ef

    def comp(g, r):
        x = g.float() + r
        xq = quantize_dequantize(x)
        r.copy_(x - xq)
        return xq.to(g.dtype)

    new_grads = pytree.tree_map(comp, grads, residual)
    return new_grads, opt_state._replace(ef=residual)


def wire_bytes_ratio(dtype: torch.dtype) -> float:
    """Compressed bytes / uncompressed bytes for the collective."""
    return (1.0 + 4.0 / BLOCK) / dtype.itemsize
