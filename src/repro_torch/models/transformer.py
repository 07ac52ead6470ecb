"""Decoder LM for the serving slice: attention mixers with dense FFNs.

The model is ``n_repeats`` copies of a ``block`` of layers, with the layer
parameters stacked on a leading axis as in the JAX package (which scans
over them); here a Python loop over the repeats takes the scan's place.
Mamba and MoE layers raise ``NotImplementedError`` until their slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from .attention import Attention, decode_attention_block, init_kv_cache
from .layers import (MLP, Embedding, ParamTree, embed_tokens, mlp_apply,
                     ones_init, rmsnorm, unembed)


def _check_spec(spec) -> None:
    if spec.mixer != "attn":
        raise NotImplementedError(
            f"mixer {spec.mixer!r} is not ported yet (attention only)")
    if spec.ffn == "moe":
        raise NotImplementedError("MoE FFNs are not ported yet")


# ----------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------
class DecoderLayer(ParamTree):
    """``_init_layer`` for an attention mixer and a dense (or no) FFN."""

    def __init__(self, spec, cfg, *, dtype, device, gen=None,
                 lead: Sequence[int] = (), d_ff: Optional[int] = None):
        super().__init__()
        _check_spec(spec)
        kw = dict(dtype=dtype, device=device, lead=lead)
        self.ln1 = ones_init((cfg.d_model,), **kw)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.qkv_bias, gen=gen, **kw)
        if spec.ffn != "none":
            self.ln2 = ones_init((cfg.d_model,), **kw)
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
            raise NotImplementedError("encoder-decoder models are not ported")
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
# Decode (serve path)
# ----------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, device) -> Dict[str, Any]:
    """The JAX cache tree ``{"prefix<i>": {"k","v"}, "blocks": {"layer<i>":
    {"k","v"}}}``; block leaves are ``(n_repeats, B, max_len, KV, Dh)``."""
    dtype = getattr(torch, cfg.dtype)
    cache: Dict[str, Any] = {}
    for i, spec in enumerate(cfg.prefix):
        _check_spec(spec)
        cache[f"prefix{i}"] = init_kv_cache(batch, max_len, cfg.n_kv_heads,
                                            cfg.head_dim, dtype, device)
    blocks = {}
    for i, spec in enumerate(cfg.block):
        _check_spec(spec)
        blocks[f"layer{i}"] = init_kv_cache(
            batch, max_len, cfg.n_kv_heads, cfg.head_dim, dtype, device,
            lead=(cfg.n_repeats,))
    cache["blocks"] = blocks
    return cache


def _decode_layer(p, spec, x, cache, index, cfg):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    mix, new_cache = decode_attention_block(p["attn"], h, cache, index,
                                            cfg=cfg)
    x = x + mix
    if spec.ffn != "none":
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h, cfg.mlp_act)
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
                                 {"k": leaf["k"][r], "v": leaf["v"][r]},
                                 index, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tie_embeddings)
    return logits, cache
