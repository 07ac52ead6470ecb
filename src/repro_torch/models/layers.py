"""Core layers in PyTorch: norms, GLU MLPs, embeddings, RoPE, init, loss.

Parameters live in :class:`ParamTree` modules whose attribute names are the
JAX package's pytree keys, so ``tree["attn"]["wq"]`` reads the same in both
packages and a state-dict key is the JAX path joined by dots.  Layouts are
the JAX ones (``wq`` is ``(d, H, Dh)``, ``wo`` is ``(H, Dh, d)``).  The
layer functions are pure functions over tensors, one per JAX function.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import is_fake
from torch.utils.checkpoint import checkpoint

Tree = Dict[str, Union[torch.Tensor, "Tree"]]


# ----------------------------------------------------------------------
# Parameter trees
# ----------------------------------------------------------------------
class ParamTree(nn.Module):
    """An ``nn.Module`` read like the JAX param dict: ``tree[name]`` and
    ``name in tree`` cover both parameters and child trees."""

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def at(self, i: int) -> Tree:
        """Plain dict of views ``leaf[i]``: one repeat of a layer-stacked
        tree, what ``jax.lax.scan`` hands its body."""
        out: Tree = {name: p[i] for name, p in self._parameters.items()}
        for name, m in self._modules.items():
            out[name] = m.at(i)
        return out


# the largest float32 draw ``dense_init`` makes at once (2 GiB)
DRAW_LIMIT_BYTES = 1 << 31


def dense_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype,
               device, scale: Optional[float] = None,
               lead: Sequence[int] = ()) -> nn.Parameter:
    """Normal(0, 1) * scale, drawn in float32 and cast, as the JAX
    ``dense_init``.  The scale rule reads the per-layer ``shape`` (fan-in is
    its first axis); ``lead`` prepends the layer-stack axes.  On the
    ``meta`` device nothing is drawn.

    A leaf whose float32 draw would exceed ``DRAW_LIMIT_BYTES`` is drawn
    slice by slice over as few leading axes as keep each slice within it,
    each slice cast straight into the leaf: a full-width expert stack
    (Moonlight's ``wi``, 8.9e9 elements) then needs no float32 copy of
    itself.  Smaller leaves are one draw, as before."""
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
    full = tuple(lead) + tuple(shape)
    if torch.device(device).type == "meta":
        t = torch.empty(full, dtype=dtype, device=device)
    elif math.prod(full) * 4 <= DRAW_LIMIT_BYTES:
        t = (torch.randn(full, generator=gen, dtype=torch.float32,
                         device=device) * scale).to(dtype)
    else:
        n = next(k for k in range(1, len(full) + 1)
                 if math.prod(full[k:]) * 4 <= DRAW_LIMIT_BYTES)
        t = torch.empty(full, dtype=dtype, device=device)
        for idx in itertools.product(*map(range, full[:n])):
            t[idx].copy_(torch.randn(full[n:], generator=gen,
                                     dtype=torch.float32, device=device)
                         * scale)
    return nn.Parameter(t, requires_grad=False)


def ones_init(shape: Sequence[int], dtype, device,
              lead: Sequence[int] = ()) -> nn.Parameter:
    return nn.Parameter(torch.ones(tuple(lead) + tuple(shape), dtype=dtype,
                                   device=device), requires_grad=False)


def zeros_init(shape: Sequence[int], dtype, device,
               lead: Sequence[int] = ()) -> nn.Parameter:
    return nn.Parameter(torch.zeros(tuple(lead) + tuple(shape), dtype=dtype,
                                    device=device), requires_grad=False)


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMS norm that multiplies by ``1 + scale`` (the JAX package's
    convention: ``scale`` starts at ones, so the initial gain is 2)."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


# ----------------------------------------------------------------------
# MLP (GLU family)
# ----------------------------------------------------------------------
class MLP(ParamTree):
    def __init__(self, d_model: int, d_ff: int, act: str, *, dtype, device,
                 gen=None, lead: Sequence[int] = ()):
        super().__init__()
        self.wi = dense_init(gen, (d_model, d_ff), dtype, device, lead=lead)
        if act in ("swiglu", "geglu"):
            self.wg = dense_init(gen, (d_model, d_ff), dtype, device,
                                 lead=lead)
        self.wo = dense_init(gen, (d_ff, d_model), dtype, device, lead=lead)


def mlp_apply(p, x: torch.Tensor, act: str) -> torch.Tensor:
    h = torch.einsum("...d,df->...f", x, p["wi"])
    if act == "swiglu":
        g = torch.einsum("...d,df->...f", x, p["wg"])
        h = F.silu(g) * h
    elif act == "geglu":
        g = torch.einsum("...d,df->...f", x, p["wg"])
        h = F.gelu(g, approximate="tanh") * h
    elif act == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("...f,fd->...d", h, p["wo"])


# ----------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------
class Embedding(ParamTree):
    def __init__(self, vocab: int, d_model: int, tie: bool, *, dtype, device,
                 gen=None):
        super().__init__()
        self.tok = dense_init(gen, (vocab, d_model), dtype, device, scale=1.0)
        if not tie:
            self.head = dense_init(gen, (d_model, vocab), dtype, device)


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.long()]


def unembed(p, x: torch.Tensor, tie: bool) -> torch.Tensor:
    if tie:
        return torch.einsum("...d,vd->...v", x, p["tok"])
    return torch.einsum("...d,dv->...v", x, p["head"])


# ----------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------
def _lse_and_gold(logits: torch.Tensor, labels: torch.Tensor):
    """fp32 logsumexp over the vocab and the logit of each label (labels
    < 0 pick class 0; the caller masks them)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp_min(0).long()[..., None])[..., 0]
    return lse, gold


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean CE; fp32 logsumexp; labels < 0 are masked."""
    lse, gold = _lse_and_gold(logits, labels)
    ce = lse - gold
    if z_loss:
        ce = ce + z_loss * torch.square(lse)
    mask = (labels >= 0).float()
    return torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _chunk_loss(embed_params, xb: torch.Tensor, lb: torch.Tensor,
                tie: bool):
    lse, gold = _lse_and_gold(unembed(embed_params, xb, tie), lb)
    mask = (lb >= 0).float()
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def fused_unembed_cross_entropy(embed_params, x: torch.Tensor,
                                labels: torch.Tensor, tie: bool,
                                chunk: int = 2048) -> torch.Tensor:
    """LM head + CE over sequence chunks: the (tokens x vocab) fp32 logits
    never exist whole.  Under autograd each chunk is checkpointed, so its
    logits are recomputed in the backward instead of saved."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    pad = -s % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, s + pad, chunk):
        args = (embed_params, x[:, c:c + chunk], labels[:, c:c + chunk], tie)
        if remat:
            t, n = checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            t, n = _chunk_loss(*args)
        tot = tot + t
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)


# ----------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """``rope_freqs`` uploaded once per device (an upload per call would
    synchronise the host with the card twice per layer)."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates the
    two split halves of the head dim, not interleaved pairs."""
    if is_fake(x):
        # traced on fake tensors: a constant of this trace (``torch.tensor``
        # is how a tracer lifts data into the graph), never cached
        freqs = torch.tensor(rope_freqs(x.shape[-1], float(theta)),
                             device=x.device)
    else:
        freqs = _rope_freqs_on(x.shape[-1], float(theta), x.device)
    angles = positions[..., :, None].float() * freqs          # (...,S,half)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
