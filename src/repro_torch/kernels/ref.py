"""Plain PyTorch versions of the port's kernels (the allclose targets).

The KV row copies are straightforward row loops, independent of the kernel
they check and of PyTorch's fused indexing operators; unlike the JAX
oracles, the scatter writes into ``pool`` in place, as the kernel does.
``flash_attention_ref`` is the JAX oracle's einsum attention, line for
line.  ``quantize_blocked_ref``/``dequantize_blocked_ref`` are the JAX
package's numpy versions (``kernels/ref.py``) in PyTorch: flatten, zero-pad
to rows of 512, per-row absmax scale, round half to even.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

QUANT_BLOCK = 512

# (source shape, source dtype, pad): what a dequantize needs besides q, s
QuantMeta = Tuple[Tuple[int, ...], torch.dtype, int]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sliding_window: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Skv,KV,D) -> (B,Sq,H,D); fp32 softmax."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d)
    scale = 1.0 / np.sqrt(d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float() * scale, k.float())
    skv = k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window:
        mask &= kpos > qpos - sliding_window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def kv_block_gather_ref(pool: torch.Tensor,
                        idx: Sequence[int]) -> torch.Tensor:
    """pool: (N,W); idx: (K,) ints -> (K,W) copies of the rows ``idx``."""
    out = torch.empty((len(idx), pool.shape[1]), dtype=pool.dtype,
                      device=pool.device)
    for k, i in enumerate(idx):
        out[k].copy_(pool[int(i)])
    return out


def kv_block_scatter_ref(pool: torch.Tensor, idx: Sequence[int],
                         blocks: torch.Tensor) -> torch.Tensor:
    """pool: (N,W); idx: (K,) ints; blocks: (K,W).  Writes ``blocks[k]``
    into row ``idx[k]`` of ``pool`` in place and returns ``pool``; every
    other row is untouched."""
    for k, i in enumerate(idx):
        pool[int(i)].copy_(blocks[k])
    return pool


def quantize_blocked_ref(x: torch.Tensor, block: int = QUANT_BLOCK
                         ) -> Tuple[torch.Tensor, torch.Tensor, QuantMeta]:
    """x: any shape, float dtype -> (q int8 (R, block), scales fp32 (R, 1),
    meta); R = ceil(numel / block), the pad read as zeros."""
    flat = x.reshape(-1).float()
    pad = -flat.numel() % block
    x2 = F.pad(flat, (0, pad)).reshape(-1, block)
    amax = x2.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently from the
    # IEEE division of the JAX package's numpy version and of the kernel
    scale = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x2 / scale), -127, 127).to(torch.int8)
    return q, scale, (tuple(x.shape), x.dtype, pad)


def dequantize_blocked_ref(q: torch.Tensor, s: torch.Tensor,
                           meta: QuantMeta) -> torch.Tensor:
    """q * s in fp32, cast to the source dtype, pad stripped, reshaped."""
    shape, dtype, pad = meta
    flat = (q.float() * s).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)
