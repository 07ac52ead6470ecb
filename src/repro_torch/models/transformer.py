"""Decoder LM: attention or Mamba-2 mixers with dense, MoE or no FFNs.

The model is ``n_repeats`` copies of a ``block`` of layers, with the layer
parameters stacked on a leading axis as in the JAX package (which scans
over them); here a Python loop over the repeats takes the scan's place.
The full-sequence forward and loss (prefill, training) and the one-token
decode step are ported for both mixers (``models/ssm.py`` holds Mamba-2);
a layer is dispatched on ``spec.mixer`` and ``spec.ffn`` as in the
reference, so hybrid blocks (Jamba's Mamba/attention interleave with MoE
on every other layer) and MoE models with a dense prefix and a shared
expert (Kimi-K2) are built and run like the pure ones.  ``models/moe.py``
holds the MoE FFN; its auxiliary load-balance loss is summed over the
layers into the forward's ``aux``, and the decode step drops it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (Attention, attention_block, decode_attention_block,
                        init_kv_cache)
from .layers import (MLP, Embedding, ParamTree, embed_tokens,
                     fused_unembed_cross_entropy, mlp_apply, ones_init,
                     rmsnorm, softmax_cross_entropy, unembed)
from .moe import MoE, moe_apply
from .ssm import Mamba2, init_ssm_cache, mamba2_block, mamba2_decode_step


# ----------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------
class DecoderLayer(ParamTree):
    """``_init_layer`` for an attention or Mamba-2 mixer and a dense, MoE
    or no FFN (``mlp`` or ``moe``, the reference's keys)."""

    def __init__(self, spec, cfg, *, dtype, device, gen=None,
                 lead: Sequence[int] = (), d_ff: Optional[int] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, lead=lead)
        self.ln1 = ones_init((cfg.d_model,), **kw)
        if spec.mixer == "attn":
            self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim, cfg.qkv_bias, gen=gen, **kw)
        else:
            self.mamba = Mamba2(cfg, gen=gen, **kw)
        if spec.ffn != "none":
            self.ln2 = ones_init((cfg.d_model,), **kw)
            if spec.ffn == "moe":
                self.moe = MoE(cfg.d_model, cfg.n_experts, cfg.moe_d_ff,
                               cfg.mlp_act, cfg.n_shared_experts, gen=gen,
                               **kw)
            else:
                self.mlp = MLP(cfg.d_model, d_ff or cfg.d_ff, cfg.mlp_act,
                               gen=gen, **kw)


class Blocks(ParamTree):
    """``params["blocks"]``: one stacked :class:`DecoderLayer` per layer of
    the super-block, each leaf shaped ``(n_repeats, ...)``."""

    def __init__(self, cfg, *, dtype, device, gen=None):
        super().__init__()
        for i, spec in enumerate(cfg.block):
            self.add_module(f"layer{i}", DecoderLayer(
                spec, cfg, dtype=dtype, device=device, gen=gen,
                lead=(cfg.n_repeats,)))


class TransformerLM(ParamTree):
    """``init_model``: the parameter tree of a decoder-only LM.  With a
    ``generator`` the weights are drawn from it; on ``device="meta"`` only
    the shapes exist (``convert.params_from_jax`` fills them)."""

    def __init__(self, cfg, *, device, generator: Optional[torch.Generator]
                 = None):
        super().__init__()
        if cfg.enc_dec:
            raise ValueError(
                "an encoder-decoder config builds models/whisper.py's "
                "WhisperModel (get_model dispatches on cfg.enc_dec)")
        dtype = getattr(torch, cfg.dtype)
        gen = generator
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model,
                               cfg.tie_embeddings, dtype=dtype, device=device,
                               gen=gen)
        for i, spec in enumerate(cfg.prefix):
            self.add_module(f"prefix{i}", DecoderLayer(
                spec, cfg, dtype=dtype, device=device, gen=gen,
                d_ff=cfg.prefix_d_ff or cfg.d_ff))
        self.blocks = Blocks(cfg, dtype=dtype, device=device, gen=gen)
        self.final_norm = ones_init((cfg.d_model,), dtype, device)


def init_model(cfg, generator: torch.Generator, device) -> TransformerLM:
    return TransformerLM(cfg, device=device, generator=generator)


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------
def _apply_layer(p, spec, x, positions, cfg, aux):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == "attn":
        x = x + attention_block(p["attn"], h, positions, cfg=cfg)
    else:
        x = x + mamba2_block(p["mamba"], h, cfg)
    if spec.ffn != "none":
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        if spec.ffn == "moe":
            ff, a = moe_apply(p["moe"], h, cfg)
            aux = aux + a
        else:
            ff = mlp_apply(p["mlp"], h, cfg.mlp_act)
        x = x + ff
    return x, aux


def _apply_superblock(p, x, positions, cfg, aux):
    for i, spec in enumerate(cfg.block):
        x, aux = _apply_layer(p[f"layer{i}"], spec, x, positions, cfg, aux)
    return x, aux


def _backbone(params: TransformerLM, tokens: torch.Tensor, cfg, *,
              extra_embeds: Optional[torch.Tensor] = None,
              remat_policy=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Everything up to (and including) the final norm: (hidden, aux).
    With autograd on, each repeat of the block is checkpointed (the
    reference's ``jax.checkpoint`` of the scan body) under ``remat_policy``
    (``core.integration.RematPolicy``: selective checkpointing through its
    ``context_fn``), else, with ``cfg.remat == "block"``, wholly."""
    x = embed_tokens(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    b, seq = x.shape[:2]
    positions = torch.arange(seq, dtype=torch.int32,
                             device=x.device).expand(b, seq)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(cfg.prefix):
        x, aux = _apply_layer(params[f"prefix{i}"], spec, x, positions, cfg,
                              aux)
    blocks = params["blocks"]

    def body(x, aux, r):
        return _apply_superblock(blocks.at(r), x, positions, cfg, aux)

    kw = {} if remat_policy is None else {
        "context_fn": remat_policy.context_fn}
    remat = torch.is_grad_enabled() and (remat_policy is not None
                                         or cfg.remat == "block")
    for r in range(cfg.n_repeats):
        if remat:
            x, aux = checkpoint(body, x, aux, r, use_reentrant=False, **kw)
        else:
            x, aux = body(x, aux, r)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


def forward(params: TransformerLM, tokens: torch.Tensor, cfg, *,
            extra_embeds: Optional[torch.Tensor] = None,
            remat_policy=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B,S_txt) int; extra_embeds: (B,S_extra,d) frontend
    embeddings prepended.  Returns (logits (B,S,V), aux_loss)."""
    x, aux = _backbone(params, tokens, cfg, extra_embeds=extra_embeds,
                       remat_policy=remat_policy)
    return unembed(params["embed"], x, cfg.tie_embeddings), aux


def loss_fn(params: TransformerLM, batch: Dict[str, torch.Tensor], cfg,
            remat_policy=None) -> torch.Tensor:
    """Token-mean CE of ``batch["labels"]`` (+ 0.01 x aux); with
    ``cfg.loss_chunk`` the LM head and CE run fused over sequence chunks."""
    labels = batch["labels"]
    if cfg.loss_chunk:
        x, aux = _backbone(params, batch["tokens"], cfg,
                           extra_embeds=batch.get("extra_embeds"),
                           remat_policy=remat_policy)
        if x.shape[1] != labels.shape[1]:
            x = x[:, -labels.shape[1]:]
        ce = fused_unembed_cross_entropy(params["embed"], x, labels,
                                         cfg.tie_embeddings,
                                         chunk=cfg.loss_chunk)
        return ce + 0.01 * aux
    logits, aux = forward(params, batch["tokens"], cfg,
                          extra_embeds=batch.get("extra_embeds"),
                          remat_policy=remat_policy)
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, -labels.shape[1]:]      # drop frontend positions
    return softmax_cross_entropy(logits, labels) + 0.01 * aux


# ----------------------------------------------------------------------
# Decode (serve path)
# ----------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, device) -> Dict[str, Any]:
    """The JAX cache tree ``{"prefix<i>": {...}, "blocks": {"layer<i>":
    {...}}}``: ``{"k","v"}`` for an attention layer, ``{"conv_x", "conv_b",
    "conv_c", "state"}`` for a Mamba-2 layer.  Block leaves lead with
    ``n_repeats`` and keep the batch on axis 1: ``(n_repeats, B, max_len,
    KV, Dh)`` and ``(n_repeats, B, ...)`` (the SSM leaves have no position
    axis)."""
    dtype = getattr(torch, cfg.dtype)

    def layer_cache(spec, lead=()):
        if spec.mixer == "attn":
            return init_kv_cache(batch, max_len, cfg.n_kv_heads,
                                 cfg.head_dim, dtype, device, lead=lead)
        return init_ssm_cache(batch, cfg, dtype, device, lead=lead)

    cache: Dict[str, Any] = {}
    for i, spec in enumerate(cfg.prefix):
        cache[f"prefix{i}"] = layer_cache(spec)
    cache["blocks"] = {f"layer{i}": layer_cache(spec, (cfg.n_repeats,))
                       for i, spec in enumerate(cfg.block)}
    return cache


def _decode_layer(p, spec, x, cache, index, cfg):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == "attn":
        mix, new_cache = decode_attention_block(p["attn"], h, cache, index,
                                                cfg=cfg)
    else:
        mix, new_cache = mamba2_decode_step(p["mamba"], h, cache, cfg)
    x = x + mix
    if spec.ffn != "none":
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        if spec.ffn == "moe":
            ff, _ = moe_apply(p["moe"], h, cfg)
        else:
            ff = mlp_apply(p["mlp"], h, cfg.mlp_act)
        x = x + ff
    return x, new_cache


def decode_step(params: TransformerLM, cfg, tokens: torch.Tensor,
                cache: Dict[str, Any], index: int):
    """One decode step.  tokens: (B,1) int; index: int position.  Returns
    (logits (B,1,V), cache); the cache is updated in place and returned."""
    x = embed_tokens(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    for i, spec in enumerate(cfg.prefix):
        x, _ = _decode_layer(params[f"prefix{i}"], spec, x,
                             cache[f"prefix{i}"], index, cfg)
    blocks = params["blocks"]
    for r in range(cfg.n_repeats):
        for i, spec in enumerate(cfg.block):
            name = f"layer{i}"
            leaf = cache["blocks"][name]
            x, _ = _decode_layer(blocks[name].at(r), spec, x,
                                 {k: t[r] for k, t in leaf.items()},
                                 index, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tie_embeddings)
    return logits, cache
