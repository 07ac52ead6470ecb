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

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import is_dtensor
from ..kernels.flash_attention import flash_attention_fwd
from .layers import (ParamTree, apply_rope, constrain, dense_init,
                     kept_shards, replicated, zeros_init)

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


def _uneven_heads(t: torch.Tensor, heads: int) -> bool:
    """Whether ``t`` is a DTensor on a mesh with an axis of extent > 1
    that does not divide ``heads``."""
    return is_dtensor(t) and any(n > 1 and heads % n
                                 for n in t.device_mesh.shape)


def head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)``.  Under a mesh with an axis whose
    extent does not divide the heads, DTensor may shard the product's
    flattened (h*k) columns over that axis (slicing a replicated weight
    costs it nothing) and then cannot split them into heads.  There the
    product runs on local shards, as the reference's XLA partitions it:
    x on its batch shards and whole otherwise, the weight gathered whole
    (its gradient a partial sum over the mesh axes that shard x).
    Elsewhere it is the einsum itself."""
    heads = w.shape[1]
    if not (_uneven_heads(x, heads) or _uneven_heads(w, heads)):
        return torch.einsum("bsd,dhk->bshk", x, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = (x if is_dtensor(x) else w).device_mesh
    x = replicated(x, mesh)
    xp = kept_shards(x)
    grad_w = [Partial() if p.is_shard() else Replicate() for p in xp]
    xl = x.redistribute(mesh, xp).to_local()
    wl = w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grad_w)
    return DTensor.from_local(torch.einsum("bsd,dhk->bshk", xl, wl), mesh,
                              xp, run_check=False)


def _project_qkv(p, x: torch.Tensor, positions: torch.Tensor, theta: float):
    q = head_proj(x, p["wq"])
    k = head_proj(x, p["wk"])
    v = head_proj(x, p["wv"])
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
    product, as in the reference.  DTensors run on each rank's local
    shards (``_on_local_shards``; on a mesh with an axis of extent > 1
    the KV heads are first repeated to the query heads)."""
    b, sq, h, d = q.shape
    if is_dtensor(q):
        if any(n > 1 for n in q.device_mesh.shape):
            k, v = _repeat_kv(k, h), _repeat_kv(v, h)
        return _on_local_shards(attend_full, q, k, v, causal=causal,
                                q_offset=q_offset,
                                sliding_window=sliding_window)
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
    ``jax.checkpoint`` per scan step).  Causal attention stops a Q chunk's
    loop at the diagonal: the reference's scan also visits the chunks
    above it, whose masked scores add exact zeros (``p = 0``, ``corr =
    1``).  DTensors run on each rank's local shards."""
    h = q.shape[2]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    k = constrain(k, ("dp", None, "tp", None))
    v = constrain(v, ("dp", None, "tp", None))
    kw = dict(causal=causal, chunk=chunk, sliding_window=sliding_window)
    if is_dtensor(q):
        return _on_local_shards(_attend_chunked, q, k, v, **kw)
    return _attend_chunked(q, k, v, **kw)


def _on_local_shards(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` of DTensors on each rank's local shards: the
    batch (dim 0) and head (dim 2) shards of q kept, every other dim
    gathered, k and v placed as q (so they need q's head count wherever
    q's heads are sharded).
    Attention is local per sequence and head, so each rank's loop runs
    on plain tensors instead of dispatching every step of it through
    DTensor.  Returns a DTensor placed as q's kept shards."""
    from torch.distributed.tensor import DTensor
    mesh = q.device_mesh
    pl = kept_shards(q, (0, 2))
    q, k, v = (t.redistribute(mesh, pl).to_local() for t in (q, k, v))
    return DTensor.from_local(fn(q, k, v, **kw), mesh, pl, run_check=False)


def _attend_chunked(q, k, v, *, causal: bool, chunk: int,
                    sliding_window: int) -> torch.Tensor:
    b, sq, h, d = q.shape
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
            if causal and ki * ckv > (qi + 1) * cq - 1:
                # this chunk and every later one lie above the diagonal:
                # fully masked, they would add exact zeros
                break
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
    q = head_proj(x, p["wq"])
    k = head_proj(ctx, p["wk"])
    v = head_proj(ctx, p["wv"])
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


def kv_cache_axes() -> Dict[str, Tuple[Optional[str], ...]]:
    """The logical axes of a KV cache leaf (B, max_len, KV, Dh): the
    sequence on ``kv_seq``, so decode reduces over a sharded sequence
    (flash-decoding; ``decode_attention_block`` writes the combine)."""
    return {"k": ("dp", "kv_seq", None, None),
            "v": ("dp", "kv_seq", None, None)}


def decode_attention_block(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                           index: int, *, cfg):
    """x: (B,1,D); cache k/v: (B,max_len,KV,D); index: current position.

    Writes position ``index`` of EVERY batch row of the cache in place (the
    JAX version returns an updated copy; the values are the same).  The
    serving engine's shadow/restore exists because of this write.  DTensor
    cache leaves (a decode step under a mesh) take
    ``_decode_attention_sharded``."""
    positions = torch.full((x.shape[0], 1), index, dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = _project_qkv(p, x, positions, cfg.rope_theta)
    if is_dtensor(cache["k"]):
        out = _decode_attention_sharded(q, k_new, v_new, cache, index, cfg)
        return torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"]), cache
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


def _decode_attention_sharded(q, k_new, v_new, cache, index: int, cfg):
    """One decode position against DTensor cache leaves whose sequence may
    be sharded (``kv_cache_axes``: ``kv_seq`` on ``"model"``), as
    flash-decoding: each rank writes ``index`` if its slice of positions
    holds it, scores every query head against its slice (global
    positions: the slice's offset plus ``arange``), and the ranks combine
    their max, sum and weighted V across the mesh dims that shard the
    sequence (all-reduces: max, then sums).  Runs on the leaves' local
    shards; the query and the new K/V are placed on the cache's batch
    shards and whole otherwise (every rank needs every head's query).
    Returns the attention output (B,1,H,Dh) in fp32, a DTensor on the
    cache's batch shards."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    kc, vc = cache["k"], cache["v"]
    mesh, cp = kc.device_mesh, tuple(kc.placements)
    if tuple(vc.placements) != cp or any(
            pl.is_shard() and pl.dim > 1 for pl in cp):
        raise ValueError(f"cache placements {cp} and {vc.placements}: "
                         f"want the batch and the sequence sharded only")
    bp = kept_shards(kc)
    ql, kn, vn = (t.redistribute(mesh, bp).to_local()
                  for t in (q, k_new, v_new))
    kl, vl = kc.to_local(), vc.to_local()
    seq_dims = [i for i, pl in enumerate(cp) if pl.is_shard(1)]
    offset = compute_local_shape_and_global_offset(kc.shape, mesh, cp)[1][1]
    b, s, kvh, d = kl.shape
    if offset <= index < offset + s:
        kl[:, index - offset:index - offset + 1] = kn.to(kl.dtype)
        vl[:, index - offset:index - offset + 1] = vn.to(vl.dtype)
    qg = _group_heads(ql, kvh)                                 # B,1,KV,G,D
    scale = 1.0 / np.sqrt(d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float() * scale, kl.float())
    kpos = offset + torch.arange(s, device=kl.device)[None, None, None,
                                                       None, :]
    mask = kpos <= index
    if cfg.sliding_window:
        mask = mask & (kpos > index - cfg.sliding_window)
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    for dim in seq_dims:
        m = funcol.all_reduce(m, "max", (mesh, dim))
    probs = torch.exp(scores - m)
    l_sum = probs.sum(dim=-1)                                  # B,KV,G,1
    acc = torch.einsum("bkgqs,bskd->bqkgd", probs, vl.float())
    for dim in seq_dims:
        l_sum = funcol.all_reduce(l_sum, "sum", (mesh, dim))
        acc = funcol.all_reduce(acc, "sum", (mesh, dim))
    out = acc / l_sum.permute(0, 3, 1, 2)[..., None]
    out = out.reshape(b, 1, qg.shape[2] * qg.shape[3], d)
    return DTensor.from_local(out, mesh, bp, run_check=False)
