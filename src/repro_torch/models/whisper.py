"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), the JAX
package's ``models/whisper.py``.

The conv frontend is a stub, as in the reference: ``audio_feats`` are
precomputed frame embeddings (B, S_enc, d_model).  The transformer backbone
is the reference's: a bidirectional encoder stack, then a causal decoder
stack with cross-attention over the encoder's output, each with its layer
parameters stacked on a leading axis (the reference scans over them; a
Python loop takes the scan's place here).  The encoder's self-attention and
the cross-attention run on ``attend_full``/``attend_chunked``; only the
decoder's causal self-attention takes the flash kernel, under
``cfg.use_flash_kernel``, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (Attention, attention_block, cross_attention_block,
                        decode_attention_block, init_kv_cache)
from .layers import (MLP, Embedding, ParamTree, embed_tokens, mlp_apply,
                     ones_init, rmsnorm, softmax_cross_entropy, unembed)


# ----------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------
class EncoderLayer(ParamTree):
    """``_init_enc_layer``: ``ln1``, self-attention ``attn``, ``ln2``,
    ``mlp``; each leaf leads with ``lead`` (the layer-stack axis)."""

    def __init__(self, cfg, *, dtype, device, gen=None,
                 lead: Sequence[int] = ()):
        super().__init__()
        kw = dict(dtype=dtype, device=device, lead=lead)
        self.ln1 = ones_init((cfg.d_model,), **kw)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.qkv_bias, gen=gen, **kw)
        self.ln2 = ones_init((cfg.d_model,), **kw)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, gen=gen, **kw)


class DecoderLayer(EncoderLayer):
    """``_init_dec_layer``: an encoder layer's leaves, then ``ln_x`` and
    the cross-attention ``xattn`` (whose biases the reference creates and
    never reads)."""

    def __init__(self, cfg, *, dtype, device, gen=None,
                 lead: Sequence[int] = ()):
        super().__init__(cfg, dtype=dtype, device=device, gen=gen, lead=lead)
        kw = dict(dtype=dtype, device=device, lead=lead)
        self.ln_x = ones_init((cfg.d_model,), **kw)
        self.xattn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.qkv_bias, gen=gen, **kw)


class WhisperModel(ParamTree):
    """``build_whisper``: ``embed``, ``enc_blocks`` (leaves lead with
    ``n_enc_layers``), ``dec_blocks`` (with ``n_layers``), ``enc_norm`` and
    ``final_norm``, so a state-dict key is the reference's path joined by
    dots.  With a ``generator`` the weights are drawn from it; on
    ``device="meta"`` only the shapes exist."""

    def __init__(self, cfg, *, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dtype = getattr(torch, cfg.dtype)
        gen = generator
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model,
                               cfg.tie_embeddings, dtype=dtype, device=device,
                               gen=gen)
        self.enc_blocks = EncoderLayer(cfg, dtype=dtype, device=device,
                                       gen=gen, lead=(cfg.n_enc_layers,))
        self.dec_blocks = DecoderLayer(cfg, dtype=dtype, device=device,
                                       gen=gen, lead=(cfg.n_layers,))
        self.enc_norm = ones_init((cfg.d_model,), dtype, device)
        self.final_norm = ones_init((cfg.d_model,), dtype, device)


def init_whisper(cfg, generator: torch.Generator, device) -> WhisperModel:
    return WhisperModel(cfg, device=device, generator=generator)


def abstract_whisper(cfg) -> WhisperModel:
    return WhisperModel(cfg, device="meta")


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------
def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def _stack(n: int, body, x: torch.Tensor, cfg, *extra) -> torch.Tensor:
    """``x`` through ``body(x, *extra, i)`` for each of ``n`` layers; with
    autograd on and ``cfg.remat == "block"`` each layer is checkpointed
    (the reference's ``jax.checkpoint`` of the scan body)."""
    remat = torch.is_grad_enabled() and cfg.remat == "block"
    for i in range(n):
        if remat:
            x = checkpoint(body, x, *extra, i, use_reentrant=False)
        else:
            x = body(x, *extra, i)
    return x


def encoder_layer(p, x: torch.Tensor, positions: torch.Tensor, cfg
                  ) -> torch.Tensor:
    """One encoder layer (the reference's scan body in ``encode``)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + attention_block(p["attn"], h, positions, cfg=cfg, causal=False)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.mlp_act)


def decoder_layer(p, x: torch.Tensor, enc_out: torch.Tensor,
                  positions: torch.Tensor, cfg) -> torch.Tensor:
    """One decoder layer over whole sequences (the scan body in
    ``decode_train``): causal self-attention, cross-attention over
    ``enc_out``, MLP."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + attention_block(p["attn"], h, positions, cfg=cfg, causal=True)
    h = rmsnorm(x, p["ln_x"], cfg.norm_eps)
    x = x + cross_attention_block(p["xattn"], h, enc_out, cfg=cfg)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.mlp_act)


def encode(params: WhisperModel, audio_feats: torch.Tensor, cfg
           ) -> torch.Tensor:
    """audio_feats: (B, S_enc, d) stub frontend embeddings."""
    x = audio_feats.to(getattr(torch, cfg.dtype))
    positions = _positions(x)
    blocks = params["enc_blocks"]

    def body(x, i):
        return encoder_layer(blocks.at(i), x, positions, cfg)

    x = _stack(cfg.n_enc_layers, body, x, cfg)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def decode_train(params: WhisperModel, tokens: torch.Tensor,
                 enc_out: torch.Tensor, cfg) -> torch.Tensor:
    """The decoder over whole token sequences: logits (B, S_dec, V)."""
    x = embed_tokens(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    positions = _positions(x)
    blocks = params["dec_blocks"]

    def body(x, enc_out, i):
        return decoder_layer(blocks.at(i), x, enc_out, positions, cfg)

    x = _stack(cfg.n_layers, body, x, cfg, enc_out)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.tie_embeddings)


def forward(params: WhisperModel, batch: Dict[str, torch.Tensor], cfg):
    """Returns (logits (B, S_dec, V), a zero aux loss), as the reference."""
    enc_out = encode(params, batch["audio_feats"], cfg)
    logits = decode_train(params, batch["tokens"], enc_out, cfg)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device)


def loss_fn(params: WhisperModel, batch: Dict[str, torch.Tensor], cfg,
            remat_policy=None) -> torch.Tensor:
    """Token-mean CE of ``batch["labels"]``.  ``remat_policy`` is taken and
    ignored, as the reference's is: ``cfg.remat`` alone decides."""
    logits, _ = forward(params, batch, cfg)
    return softmax_cross_entropy(logits, batch["labels"])


# ----------------------------------------------------------------------
# Decode (serve path): cached self-attention + cross-attention
# ----------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, device) -> Dict[str, Any]:
    """``{"self": {"k", "v"}}``, each leaf (n_layers, B, max_len, KV,
    Dh)."""
    return {"self": init_kv_cache(batch, max_len, cfg.n_kv_heads,
                                  cfg.head_dim, getattr(torch, cfg.dtype),
                                  device, lead=(cfg.n_layers,))}


def decode_step(params: WhisperModel, cfg, tokens: torch.Tensor,
                cache: Dict[str, Any], index: int, enc_out: torch.Tensor):
    """One decoder token against the cached self-attention K/V and the
    encoder's output.  tokens: (B,1) int; enc_out: (B, S_enc, d).  Returns
    (logits (B,1,V), cache); the cache is written in place, as the LM
    decode's is.  Like the reference, each layer projects K/V of
    ``enc_out`` anew at every step."""
    x = embed_tokens(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    blocks = params["dec_blocks"]
    self_cache = cache["self"]
    for i in range(cfg.n_layers):
        p = blocks.at(i)
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        mix, _ = decode_attention_block(
            p["attn"], h, {k: t[i] for k, t in self_cache.items()}, index,
            cfg=cfg)
        x = x + mix
        h = rmsnorm(x, p["ln_x"], cfg.norm_eps)
        x = x + cross_attention_block(p["xattn"], h, enc_out, cfg=cfg)
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h, cfg.mlp_act)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.tie_embeddings), cache
