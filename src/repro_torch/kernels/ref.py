"""Plain PyTorch versions of the port's kernels (the allclose targets).

The KV row copies of a 2-D pool are straightforward row loops,
independent of the kernel they check and of PyTorch's fused indexing
operators; the leaf forms are ``index_select``/``index_copy_`` along the
slot axis.  Unlike the JAX oracles, the scatter writes into ``pool`` in
place, as the kernel does.
``flash_attention_ref`` is the JAX oracle's einsum attention, line for
line, and ``ssd_intra_chunk_ref`` is its SSD oracle (with ``_segsum``),
fp32 throughout, its prefix sums rounded as the CPU rounds them
(``cumsum64``).  ``quantize_blocked_ref``/``dequantize_blocked_ref`` are
the JAX package's numpy versions (``kernels/ref.py``) in PyTorch: flatten,
zero-pad to rows of 512, per-row absmax scale, round half to even.
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


def cumsum64(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum`` as it runs on the CPU on every device: accumulated
    in float64, each output rounded once to x's dtype.  On the card an fp32
    cumsum accumulates in fp32, adding up to half an ulp of the running sum
    per term; at |cum| ~ 200 (a 256-long SSD chunk at full width, where the
    ulp is 1.5e-5) ``exp(cum_i - cum_j)`` carries that into the SSD's
    output at the order of its 1e-4 tolerance.  With this the CPU, the card
    and the kernel (``csrc/ssd_scan.cu``) round the prefix sums alike."""
    return torch.cumsum(x, dim, dtype=torch.float64).to(x.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """L[..., i, j] = sum_{j<k<=i} x_k for i >= j, else -inf.  The oracle
    and the plain chunked path of ``models.ssm`` share it, so their prefix
    sums round alike."""
    s = cumsum64(x, -1)
    diff = s[..., :, None] - s[..., None, :]
    q = x.shape[-1]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_intra_chunk_ref(xc: torch.Tensor, dtc: torch.Tensor,
                        da: torch.Tensor, bc: torch.Tensor, cc: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc: (B,NC,Q,H,P); dtc/da: (B,NC,Q,H); bc/cc: (B,NC,Q,N)
    -> y_diag (B,NC,Q,H,P) fp32, states (B,NC,H,P,N) fp32."""
    xc32, da32, dt32, b32, c32 = (t.float() for t in (xc, da, dtc, bc, cc))
    lmat = torch.exp(_segsum(da32.movedim(2, 3)))          # (B,NC,H,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", c32, b32)
    y = torch.einsum("bcqk,bchqk,bckh,bckhp->bcqhp", scores, lmat, dt32,
                     xc32)
    cum = cumsum64(da32, 2)
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bcqh,bcqh,bcqn,bcqhp->bchpn", decay_end, dt32,
                          b32, xc32)
    return y, states


def _leaf_args(pool, axis, other=None):
    """(leaves, axes, others) of the one-leaf or list form of the KV
    copies; a ``None`` axis is the 2-D row pool's."""
    if torch.is_tensor(pool):
        return [pool], [axis], [other]
    axes = [axis] * len(pool) if axis is None or isinstance(axis, int) \
        else list(axis)
    return list(pool), axes, list(other) if other is not None else None


def kv_block_gather_ref(pool, idx: Sequence[int], *, axis=None):
    """pool: (N,W); idx: (K,) ints -> (K,W) copies of the rows ``idx``.

    With ``axis``, pool is a cache leaf with its slot on that axis, and the
    result the contiguous (K, *shape[:axis], *shape[axis+1:]) tensor of
    ``index_select`` along it; a list of leaves (``axis`` one int or one
    per leaf) gives the list of results."""
    leaves, axes, _ = _leaf_args(pool, axis)
    outs = []
    for leaf, a in zip(leaves, axes):
        if a is None:
            out = torch.empty((len(idx), leaf.shape[1]), dtype=leaf.dtype,
                              device=leaf.device)
            for k, i in enumerate(idx):
                out[k].copy_(leaf[int(i)])
        else:
            rows = torch.tensor([int(i) for i in idx], dtype=torch.long,
                                device=leaf.device)
            out = leaf.index_select(a, rows).movedim(a, 0).contiguous()
        outs.append(out)
    return outs[0] if torch.is_tensor(pool) else outs


def kv_block_scatter_ref(pool, idx: Sequence[int], blocks, *, axis=None):
    """pool: (N,W); idx: (K,) ints; blocks: (K,W).  Writes ``blocks[k]``
    into row ``idx[k]`` of ``pool`` in place and returns ``pool``; every
    other row is untouched.

    With ``axis`` (and a list of leaves), the inverse of
    ``kv_block_gather_ref``: each block, (K, *shape[:axis],
    *shape[axis+1:]), goes into its leaf by ``index_copy_`` along ``axis``,
    in place."""
    leaves, axes, srcs = _leaf_args(pool, axis, blocks)
    for leaf, a, src in zip(leaves, axes, srcs):
        if a is None:
            for k, i in enumerate(idx):
                leaf[int(i)].copy_(src[k])
        else:
            rows = torch.tensor([int(i) for i in idx], dtype=torch.long,
                                device=leaf.device)
            leaf.index_copy_(a, rows, src.movedim(0, a))
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
