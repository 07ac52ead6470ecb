"""Int8 block-quantized gradients with error feedback (the residual is
carried to the next step, Seide et al. 2014 / EF-SGD): the JAX package's
``optim/compression.py`` with the same arithmetic, bit for bit.

Two layers, as in the reference:

* ``compressed_psum_mean(x, group)`` — a real collective over a process
  group: int8-quantize the local contribution, reduce the scales with MAX,
  renormalise to the shared scale, integer-sum (int32 ``all_reduce``),
  dequantize and divide by the group's size.  1 B per element plus 4 B
  per block on the wire, ``wire_bytes_ratio`` of the plain bytes.
* ``ef_compress_grads`` — the train-step integration: quantize/dequantize
  with error feedback applied to the already-reduced gradients.  A DTensor
  gradient is quantized in the blocks of its whole flattened leaf, as the
  reference quantizes its global arrays, never in each shard's own.

This is plain torch, as the reference's is plain ``jnp``: 2048-element
blocks with one fp32 scale each, not the 512-element rows of
``kernels/offload_quant``.  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils._pytree as pytree

from ..device import is_dtensor

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
def compressed_psum_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (default: the world)
    through an int8 exchange, in the reference's fp32 arithmetic: each
    rank's blocks quantized on their own scale, the scales MAX-reduced,
    the int8 values renormalised to the shared scale and rounded, summed
    as int32, dequantized and divided by the group's size.  Every rank
    gets the same result."""
    n = dist.get_world_size(group)
    q, scale, pad = _quant(x.float())
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    # renormalise local values to the shared scale, then integer-reduce
    q_shared = torch.clamp(torch.round(q.float() * scale / scale_max),
                           -127, 127).to(torch.int32)
    dist.all_reduce(q_shared, op=dist.ReduceOp.SUM, group=group)
    out = _dequant(q_shared, scale_max, pad, x.shape, x.dtype)
    return out / torch.full((), float(n), dtype=out.dtype, device=out.device)


def _quantize_whole(x: torch.Tensor) -> torch.Tensor:
    """``quantize_dequantize`` of the global value of ``x``: a DTensor is
    gathered, quantized whole and its own shard kept, on every rank."""
    if not is_dtensor(x):
        return quantize_dequantize(x)
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(quantize_dequantize(x.full_tensor()),
                             x.device_mesh, x.placements, src_data_rank=None)


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
        lambda g: torch.zeros_like(g, dtype=torch.float32)
        if is_dtensor(g) else torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device),
        grads) if fresh else opt_state.ef

    def comp(g, r):
        x = g.float() + r
        xq = _quantize_whole(x)
        r.copy_(x - xq)
        return xq.to(g.dtype)

    new_grads = pytree.tree_map(comp, grads, residual)
    return new_grads, opt_state._replace(ef=residual)


def wire_bytes_ratio(dtype: torch.dtype) -> float:
    """Compressed bytes / uncompressed bytes for the collective."""
    return (1.0 + 4.0 / BLOCK) / dtype.itemsize
