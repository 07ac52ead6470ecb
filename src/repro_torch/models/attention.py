"""Attention for one-token decode: GQA + RoPE against a KV cache.

Only the decode path is ported here; the full-sequence forward (and the
flash-attention kernel behind it) belongs to the LM forward slice.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .layers import ParamTree, apply_rope, dense_init, zeros_init

NEG_INF = -1e30


class Attention(ParamTree):
    """``init_attention``: ``wq``/``wk``/``wv`` are ``(d, heads, Dh)`` and
    ``wo`` is ``(H, Dh, d)``, as in the JAX package."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, qkv_bias: bool, *, dtype, device, gen=None,
                 lead: Sequence[int] = ()):
        super().__init__()
        kw = dict(dtype=dtype, device=device, lead=lead)
        self.wq = dense_init(gen, (d_model, n_heads, head_dim), **kw)
        self.wk = dense_init(gen, (d_model, n_kv_heads, head_dim), **kw)
        self.wv = dense_init(gen, (d_model, n_kv_heads, head_dim), **kw)
        self.wo = dense_init(gen, (n_heads, head_dim, d_model), **kw)
        if qkv_bias:
            self.bq = zeros_init((n_heads, head_dim), **kw)
            self.bk = zeros_init((n_kv_heads, head_dim), **kw)
            self.bv = zeros_init((n_kv_heads, head_dim), **kw)


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
