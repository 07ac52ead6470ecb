"""Mamba-2 language model (arXiv:2405.21060, ``state-spaces/mamba2-780m``),
in plain float32 PyTorch.

Each layer: x += Mixer(RMSNorm(x)).  The mixer projects x to z, x', B, C
(one group) and dt; runs a causal depthwise convolution of width
``d_conv`` followed by SiLU over x', B and C; dt = softplus(dt + dt_bias);
A = -exp(A_log); the SSD scan (the paper's ``ssd_minimal_discrete``
listing: chunked, the state carried across chunks) of X = x'·dt with
decay A·dt; y += D·x'; then RMSNorm(y · silu(z)) and the out projection.
A final RMSNorm, then logits against the embedding table (tied).
Departures, as the program keeps its weights: the norm weight ``w``
scales by ``1 + w``; the in-projection is stored as one matrix per
component (z, x, B, C, dt) and the convolution as one weight per
component, which is the published layout split along its output axis.
Weights are drawn as ``param_specs`` says: the embedding table with the
config's ``initializer_range``, each projection at 1/sqrt(its fan-in).
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .common import Numerics, Spec, normal, rmsnorm, token_ce_sum


def dims(c: dict) -> dict:
    d = c["d_model"]
    dinner = c["expand"] * d
    return dict(d=d, dinner=dinner, heads=dinner // c["headdim"],
                p=c["headdim"], n=c["d_state"], w=c["d_conv"],
                chunk=c["chunk_size"], layers=c["n_layer"],
                vocab=c["padded_vocab_size"], eps=c["norm_epsilon"])


def param_specs(c: dict) -> List[Spec]:
    m = dims(c)
    d, di, h, n, w, L, v = (m[k] for k in ("d", "dinner", "heads", "n", "w",
                                           "layers", "vocab"))
    pre = "blocks.layer0."
    mx = pre + "mamba."
    out = [Spec("final_norm", (d,), ("const", 1.0)),
           Spec("embed.tok", (v, d),
                normal((v, d), scale=c["initializer_range"]))]
    if not c["tie_embeddings"]:
        out.append(Spec("embed.head", (d, v), normal((d, v))))
    out += [Spec(pre + "ln1", (L, d), ("const", 1.0)),
            Spec(mx + "wz", (L, d, di), normal((d,))),
            Spec(mx + "wx", (L, d, di), normal((d,))),
            Spec(mx + "wb", (L, d, n), normal((d,))),
            Spec(mx + "wc", (L, d, n), normal((d,))),
            Spec(mx + "wdt", (L, d, h), normal((d,))),
            Spec(mx + "conv_wx", (L, w, di), normal((w,))),
            Spec(mx + "conv_bx", (L, di), ("const", 0.0)),
            Spec(mx + "conv_wb", (L, w, n), normal((w,))),
            Spec(mx + "conv_bb", (L, n), ("const", 0.0)),
            Spec(mx + "conv_wc", (L, w, n), normal((w,))),
            Spec(mx + "conv_bc", (L, n), ("const", 0.0)),
            Spec(mx + "a_log", (L, h), ("const", 0.0)),
            Spec(mx + "d_skip", (L, h), ("const", 1.0)),
            Spec(mx + "dt_bias", (L, h), ("const", 0.0)),
            Spec(mx + "norm_scale", (L, di), ("const", 1.0)),
            Spec(mx + "out_proj", (L, di, d), normal((di,)))]
    return out


def causal_conv(u: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution, then SiLU.  u: (B, S, C); w: (W, C),
    tap W-1 on the current position."""
    width, ch = w.shape
    out = F.conv1d(u.transpose(1, 2), w.t()[:, None, :], b,
                   padding=width - 1, groups=ch)[..., :u.shape[1]]
    return F.silu(out.transpose(1, 2))


def segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = x[..., j+1] + ... + x[..., i] for i >= j, else
    -inf."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        chunk: int, num: Numerics = Numerics()) -> torch.Tensor:
    """x: (B, S, H, P); a: (B, S, H); b, c: (B, S, N), one group shared by
    the heads.  Returns y: (B, S, H, P) from a zero state; ``num.low``
    rounds what the program computes in float32."""
    bs, s, h, p = x.shape
    nc = s // chunk
    x = x.reshape(bs, nc, chunk, h, p)
    b = b.reshape(bs, nc, chunk, -1)
    c = c.reshape(bs, nc, chunk, -1)
    a = a.reshape(bs, nc, chunk, h).permute(0, 3, 1, 2)        # b h c l
    a_cum = num.low(torch.cumsum(a, dim=-1))
    # 1. within each chunk (the diagonal blocks)
    decay = num.low(torch.exp(segsum(a)))                      # b h c l s
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", c, b, decay, x)
    # 2. each chunk's final state from its own inputs
    to_end = torch.exp(a_cum[..., -1:] - a_cum)                # b h c l
    states = num.low(torch.einsum("bcln,bhcl,bclhp->bchpn", b, to_end, x))
    # 3. the recurrence across chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))  # b h z c
    states = torch.einsum("bhzc,bchpn->bzhpn", across, states)[:, :-1]
    # 4. each chunk's entering state to its outputs
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", c, states,
                         torch.exp(a_cum))
    return num.low(y_diag + y_off).reshape(bs, s, h, p)


def loss_sum(p: Dict[str, torch.Tensor], tokens: torch.Tensor,
             labels: torch.Tensor, c: dict,
             num: Numerics = Numerics()) -> torch.Tensor:
    """The summed token cross-entropy of ``labels`` given ``tokens``."""
    m = dims(c)
    mx = "blocks.layer0.mamba."
    x = num.act(p["embed.tok"][tokens.long()])
    bs, s, _ = x.shape
    for i in range(m["layers"]):
        def w(name):
            return p[mx + name][i]
        h = num.act(rmsnorm(x, p["blocks.layer0.ln1"][i], m["eps"]))
        z = num.linear("bsd,di->bsi", h, w("wz"))
        xc = causal_conv(num.linear("bsd,di->bsi", h, w("wx")),
                         w("conv_wx"), w("conv_bx"))
        bb = causal_conv(num.linear("bsd,dn->bsn", h, w("wb")),
                         w("conv_wb"), w("conv_bb"))
        cc = causal_conv(num.linear("bsd,dn->bsn", h, w("wc")),
                         w("conv_wc"), w("conv_bc"))
        dt = num.low(F.softplus(num.linear("bsd,dh->bsh", h, w("wdt"))
                                + w("dt_bias")))
        a = -torch.exp(w("a_log"))
        xh = xc.reshape(bs, s, m["heads"], m["p"])
        y = ssd(xh * dt[..., None], a * dt, bb, cc, m["chunk"], num)
        y = num.act(y + xh * w("d_skip")[:, None])
        y = num.act(rmsnorm(y.reshape(bs, s, m["dinner"]) * F.silu(z),
                            w("norm_scale"), m["eps"]))
        x = num.act(x + num.linear("bsi,id->bsd", y, w("out_proj")))
    x = num.act(rmsnorm(x, p["final_norm"], m["eps"]))
    if c["tie_embeddings"]:
        logits = num.linear("bsd,vd->bsv", x, p["embed.tok"])
    else:
        logits = num.linear("bsd,dv->bsv", x, p["embed.head"])
    return token_ce_sum(logits, labels)
