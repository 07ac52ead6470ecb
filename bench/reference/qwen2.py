"""Qwen2 decoder (Qwen2.5: arXiv:2412.15115, and its published
config.json), in plain float32 PyTorch.

Each layer: x += Attn(RMSNorm(x)), x += SwiGLU(RMSNorm(x)).  Attention is
grouped-query with biases on the q, k and v projections, rotary position
embeddings on the two halves of each head (``rotate_half``), causal, and
scaled by 1/sqrt(head size); the MLP is ``down(silu(gate(x)) * up(x))``.
A final RMSNorm, then the untied LM head (or the embedding table's
transpose where ``tie_word_embeddings``).  Departures, as the program
keeps its weights: the norm weight ``w`` scales by ``1 + w``; projections
are stored (in, heads, head size) and (heads, head size, out).  Weights
are drawn as ``param_specs`` says: the embedding table with the config's
``initializer_range``, each projection at 1/sqrt(its fan-in).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from .common import Numerics, Spec, normal, rmsnorm, token_ce_sum


def dims(c: dict) -> dict:
    d, h = c["hidden_size"], c["num_attention_heads"]
    return dict(d=d, h=h, kv=c["num_key_value_heads"],
                hd=c.get("head_dim", d // h), ff=c["intermediate_size"],
                layers=c["num_hidden_layers"], vocab=c["padded_vocab_size"],
                eps=c["rms_norm_eps"], theta=c["rope_theta"],
                tie=c["tie_word_embeddings"])


def param_specs(c: dict) -> List[Spec]:
    m = dims(c)
    d, h, kv, hd, ff, L, v = (m[k] for k in ("d", "h", "kv", "hd", "ff",
                                             "layers", "vocab"))
    pre = "blocks.layer0."
    out = [Spec("final_norm", (d,), ("const", 1.0)),
           Spec("embed.tok", (v, d),
                normal((v, d), scale=c["initializer_range"]))]
    if not m["tie"]:
        out.append(Spec("embed.head", (d, v), normal((d, v))))
    out += [Spec(pre + "ln1", (L, d), ("const", 1.0)),
            Spec(pre + "ln2", (L, d), ("const", 1.0)),
            Spec(pre + "attn.wq", (L, d, h, hd), normal((d,))),
            Spec(pre + "attn.wk", (L, d, kv, hd), normal((d,))),
            Spec(pre + "attn.wv", (L, d, kv, hd), normal((d,))),
            Spec(pre + "attn.wo", (L, h, hd, d), normal((h,))),
            Spec(pre + "attn.bq", (L, h, hd), ("const", 0.0)),
            Spec(pre + "attn.bk", (L, kv, hd), ("const", 0.0)),
            Spec(pre + "attn.bv", (L, kv, hd), ("const", 0.0)),
            Spec(pre + "mlp.wi", (L, d, ff), normal((d,))),
            Spec(pre + "mlp.wg", (L, d, ff), normal((d,))),
            Spec(pre + "mlp.wo", (L, ff, d), normal((ff,)))]
    return out


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, heads, hd); rotates the halves (i, i + hd/2) by position
    times theta^(-2i/hd)."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (torch.arange(s, dtype=torch.float64, device=x.device)[:, None]
           * inv[None, :]).to(torch.float32)
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def loss_sum(p: Dict[str, torch.Tensor], tokens: torch.Tensor,
             labels: torch.Tensor, c: dict,
             num: Numerics = Numerics()) -> torch.Tensor:
    """The summed token cross-entropy of ``labels`` given ``tokens``."""
    m = dims(c)
    pre = "blocks.layer0."
    x = num.act(p["embed.tok"][tokens.long()])
    s = x.shape[1]
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    group = m["h"] // m["kv"]
    for i in range(m["layers"]):
        def w(name):
            return p[pre + name][i]
        h = num.act(rmsnorm(x, w("ln1"), m["eps"]))
        q = num.linear("bsd,dhk->bshk", h, w("attn.wq")) + w("attn.bq")
        k = num.linear("bsd,dhk->bshk", h, w("attn.wk")) + w("attn.bk")
        v = num.linear("bsd,dhk->bshk", h, w("attn.wv")) + w("attn.bv")
        q, k = rope(q, m["theta"]), rope(k, m["theta"])
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
        sc = num.low(torch.einsum("bqhk,bshk->bhqs", q, k)
                     / math.sqrt(m["hd"]))
        sc = sc.masked_fill(~causal, float("-inf"))
        o = torch.einsum("bhqs,bshk->bqhk", num.low(sc.softmax(-1)), v)
        x = num.act(x + num.linear("bshk,hkd->bsd", o, w("attn.wo")))
        h = num.act(rmsnorm(x, w("ln2"), m["eps"]))
        g = torch.nn.functional.silu(num.linear("bsd,df->bsf", h,
                                                w("mlp.wg")))
        u = num.linear("bsd,df->bsf", h, w("mlp.wi"))
        x = num.act(x + num.linear("bsf,fd->bsd", g * u, w("mlp.wo")))
    x = num.act(rmsnorm(x, p["final_norm"], m["eps"]))
    if m["tie"]:
        logits = num.linear("bsd,vd->bsv", x, p["embed.tok"])
    else:
        logits = num.linear("bsd,dv->bsv", x, p["embed.head"])
    return token_ce_sum(logits, labels)
