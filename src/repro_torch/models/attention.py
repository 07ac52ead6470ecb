"""Attention: GQA/MQA + RoPE, with three full-sequence paths and decode.

* ``attend_full``    — plain einsum attention (short sequences).
* ``attend_chunked`` — online softmax over KV chunks in plain PyTorch: the
  (S x S) score tensor never exists; each KV step is checkpointed, so the
  backward recomputes its probability tile instead of saving it.
* ``flash_attention_fwd`` (``kernels/flash_attention.py``) — the
  hand-written CUDA kernel, selected with ``cfg.use_flash_kernel`` for
  causal attention; forward only.

Decode: one-token query against a KV cache.  Cross-attention
(``cross_attention_block``, whisper's decoder): queries from the decoder,
keys and values from the encoder's output, on ``attend_full`` or
``attend_chunked`` as the reference has it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention_fwd
from .layers import ParamTree, apply_rope, constrain, dense_init, zeros_init

NEG_INF = -1e30


class Attention(ParamTree):
    """``init_attention``: ``wq``/``wk``/``wv`` are ``(d, heads, Dh)`` and
    ``wo`` is ``(H, Dh, d)``, as in the JAX package."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, qkv_bias: bool, *, dtype, device, gen=None,
                 lead: Sequence[int] = ()):
        super().__init__()
        kw = dict(dtype=dtype, device=device, lead=lead)
        self.wq = dense_init(gen, (d_model, n_heads, head_dim),
                             axes=("embed", "heads", None), **kw)
        self.wk = dense_init(gen, (d_model, n_kv_heads, head_dim),
                             axes=("embed", "kv_heads", None), **kw)
        self.wv = dense_init(gen, (d_model, n_kv_heads, head_dim),
                             axes=("embed", "kv_heads", None), **kw)
        self.wo = dense_init(gen, (n_heads, head_dim, d_model),
                             axes=("heads", None, "embed"), **kw)
        if qkv_bias:
            self.bq = zeros_init((n_heads, head_dim), axes=("heads", None),
                                 **kw)
            self.bk = zeros_init((n_kv_heads, head_dim),
                                 axes=("kv_heads", None), **kw)
            self.bv = zeros_init((n_kv_heads, head_dim),
                                 axes=("kv_heads", None), **kw)


def _project_qkv(p, x: torch.Tensor, positions: torch.Tensor, theta: float):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    return q, k, v


def _group_heads(q: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """(B,S,H,D) -> (B,S,KV,G,D) splitting query heads into KV groups."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv_heads, h // n_kv_heads, d)


def attend_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, q_offset: int = 0,
                sliding_window: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Skv,KV,D).  Returns (B,Sq,H,D) in v's dtype:
    fp32 scores and softmax, probabilities cast to v's dtype for the PV
    product, as in the reference."""
    b, sq, h, d = q.shape
    qg = _group_heads(q, k.shape[2])                       # B,Sq,KV,G,D
    scale = 1.0 / np.sqrt(d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float() * scale, k.float())
    if causal or sliding_window:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if sliding_window:
            mask &= kpos > qpos - sliding_window
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, d)


def _repeat_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """Broadcast KV heads to the full query-head count: kv head ``i``
    serves query heads ``i*G .. i*G+G-1``, as ``jnp.repeat`` lays them."""
    kvh = k.shape[2]
    if kvh == h:
        return k
    return torch.repeat_interleave(k, h // kvh, dim=2)


def _kv_step(m, l, acc, qblk, kblk, vblk, mask, scale):
    """One online-softmax step over a KV chunk.  The products take the
    working dtype's operands with fp32 sums (the reference's
    ``preferred_element_type=float32``): widened to fp32, a bf16 product
    is exact."""
    s = torch.einsum("bqhd,bshd->bhqs", qblk.float(), kblk.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhqs,bshd->bhqd", p.to(vblk.dtype).float(), vblk.float())
    return m_new, l_new, acc_new


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, chunk: int = 1024,
                   sliding_window: int = 0) -> torch.Tensor:
    """Online-softmax attention, looping over KV chunks per Q chunk.  The
    peak score tile is (B,H,Cq,Ckv), independent of the sequence length.
    Under autograd each KV step is checkpointed (the reference's
    ``jax.checkpoint`` per scan step)."""
    b, sq, h, d = q.shape
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    k = constrain(k, ("dp", None, "tp", None))
    v = constrain(v, ("dp", None, "tp", None))
    skv = k.shape[1]
    cq, ckv = min(chunk, sq), min(chunk, skv)
    sq_pad, skv_pad = -sq % cq, -skv % ckv
    if sq_pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, sq_pad))
    if skv_pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, skv_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, skv_pad))
    nq, nk = (sq + sq_pad) // cq, (skv + skv_pad) // ckv
    scale = float(np.float32(1.0 / np.sqrt(d)))
    kpos_all = torch.arange(nk * ckv, device=q.device).reshape(nk, ckv)
    remat = torch.is_grad_enabled()
    outs = []
    for qi in range(nq):
        qblk = q[:, qi * cq:(qi + 1) * cq]
        qpos = qi * cq + torch.arange(cq, device=q.device)
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, cq, d), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            kpos = kpos_all[ki]
            mask = (kpos < skv)[None, :]
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if sliding_window:
                mask = mask & (kpos[None, :] > qpos[:, None] - sliding_window)
            args = (m, l, acc, qblk, k[:, ki * ckv:(ki + 1) * ckv],
                    v[:, ki * ckv:(ki + 1) * ckv], mask, scale)
            if remat:
                m, l, acc = checkpoint(_kv_step, *args, use_reentrant=False)
            else:
                m, l, acc = _kv_step(*args)
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))  # B,H,Cq,D
    out = torch.stack(outs, dim=1).transpose(2, 3)          # B,nq,Cq,H,D
    return out.reshape(b, nq * cq, h, d)[:, :sq].to(q.dtype)


def attention_block(p, x: torch.Tensor, positions: torch.Tensor, *, cfg,
                    causal: bool = True,
                    use_chunked: Optional[bool] = None) -> torch.Tensor:
    """Self-attention over x: (B,S,D_model)."""
    q, k, v = _project_qkv(p, x, positions, cfg.rope_theta)
    q = constrain(q, ("dp", None, "tp", None))
    k = constrain(k, ("dp", None, "tp_kv", None))
    v = constrain(v, ("dp", None, "tp_kv", None))
    if use_chunked is None:
        use_chunked = x.shape[1] > 2 * cfg.attn_chunk
    if cfg.use_flash_kernel and causal:
        out = flash_attention_fwd(q, k, v, causal=True,
                                  sliding_window=cfg.sliding_window)
    elif use_chunked:
        out = attend_chunked(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                             sliding_window=cfg.sliding_window)
    else:
        out = attend_full(q, k, v, causal=causal,
                          sliding_window=cfg.sliding_window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def cross_attention_block(p, x: torch.Tensor, ctx: torch.Tensor, *,
                          cfg) -> torch.Tensor:
    """Decoder cross-attention: queries from x (B,Sq,D_model), keys and
    values from ctx (B,Skv,D_model).  No rope and no bias, as the
    reference (which never reads ``bq``/``bk``/``bv`` here, so their
    gradients are zeros)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", ctx, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", ctx, p["wv"])
    if max(q.shape[1], k.shape[1]) > 2 * cfg.attn_chunk:
        out = attend_chunked(q, k, v, causal=False, chunk=cfg.attn_chunk)
    else:
        out = attend_full(q, k, v, causal=False)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  dtype, device, lead: Sequence[int] = ()
                  ) -> Dict[str, torch.Tensor]:
    shape = tuple(lead) + (batch, max_len, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention_block(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                           index: int, *, cfg):
    """x: (B,1,D); cache k/v: (B,max_len,KV,D); index: current position.

    Writes position ``index`` of EVERY batch row of the cache in place (the
    JAX version returns an updated copy; the values are the same).  The
    serving engine's shadow/restore exists because of this write."""
    positions = torch.full((x.shape[0], 1), index, dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = _project_qkv(p, x, positions, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    k[:, index:index + 1] = k_new.to(k.dtype)
    v[:, index:index + 1] = v_new.to(v.dtype)
    b, s, kvh, d = k.shape
    qg = _group_heads(q, kvh)                                  # B,1,KV,G,D
    scale = 1.0 / np.sqrt(d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float() * scale, k.float())
    kpos = torch.arange(s, device=x.device)[None, None, None, None, :]
    mask = kpos <= index
    if cfg.sliding_window:
        mask = mask & (kpos > index - cfg.sliding_window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    out = out.reshape(b, 1, qg.shape[2] * qg.shape[3], d).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache
