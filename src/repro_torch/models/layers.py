"""Core layers in PyTorch: norms, GLU MLPs, embeddings, RoPE, init, loss.

Parameters live in :class:`ParamTree` modules whose attribute names are the
JAX package's pytree keys, so ``tree["attn"]["wq"]`` reads the same in both
packages and a state-dict key is the JAX path joined by dots.  Layouts are
the JAX ones (``wq`` is ``(d, H, Dh)``, ``wo`` is ``(H, Dh, d)``).  The
layer functions are pure functions over tensors, one per JAX function.

Every initializer takes the leaf's *logical* axes (``"embed"``,
``"heads"``, ``"mlp"``, ...), as the reference's ``ParamBuilder`` records
them, and the tree keeps them beside its leaves: ``tree.param_axes()`` is
the reference's axes tree, a layer-stacked leaf's led by ``"layers"``.
``launch.sharding`` maps them onto a mesh.  Activation constraints go
through ``constrain``, a no-op until ``launch.sharding`` installs rules.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import is_fake
from torch.utils.checkpoint import checkpoint

from ..device import is_dtensor

Tree = Dict[str, Union[torch.Tensor, "Tree"]]
Axes = Tuple[Optional[str], ...]

# ----------------------------------------------------------------------
# Activation-sharding context (installed by launch.sharding.use_rules()).
# ----------------------------------------------------------------------
_ACTIVE_RULES = None


def set_active_rules(rules) -> None:
    global _ACTIVE_RULES
    _ACTIVE_RULES = rules


def active_rules():
    return _ACTIVE_RULES


def kept_shards(t, dims: Tuple[int, ...] = (0,)) -> list:
    """The placements of DTensor ``t`` with only its shards of tensor
    dims ``dims`` kept and every other mesh axis replicated: how a
    computation that is local per index of those dims places its
    operands before it runs on their local shards."""
    from torch.distributed.tensor import Replicate
    return [p if p.is_shard() and p.dim in dims else Replicate()
            for p in t.placements]


def replicated(t: torch.Tensor, mesh):
    """``t`` as a DTensor on ``mesh``: itself if it is one, else
    replicated (every rank holds the same value)."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def constrain(x: torch.Tensor, logical: Axes) -> torch.Tensor:
    """Constrain an activation to the mesh mapping of ``logical`` axes."""
    if _ACTIVE_RULES is None:
        return x
    return _ACTIVE_RULES.constrain(x, logical)


# ----------------------------------------------------------------------
# Parameter trees
# ----------------------------------------------------------------------
class ParamTree(nn.Module):
    """An ``nn.Module`` read like the JAX param dict: ``tree[name]`` and
    ``name in tree`` cover both parameters and child trees.  A parameter
    made by one of this module's initializers brings its logical axes,
    which the tree records under the leaf's name (so they outlive a
    ``load_state_dict(assign=True)``)."""

    def __init__(self):
        super().__init__()
        self._leaf_axes: Dict[str, Axes] = {}

    def __setattr__(self, name: str, value) -> None:
        axes = getattr(value, "logical_axes", None)
        if axes is not None:
            self._leaf_axes[name] = axes
        super().__setattr__(name, value)

    def param_axes(self) -> Dict[str, object]:
        """The logical axes of every leaf, in the tree's structure."""
        out: Dict[str, object] = {}
        for name in self._parameters:
            out[name] = self._leaf_axes[name]
        for name, m in self._modules.items():
            out[name] = m.param_axes()
        return out

    def named_param_axes(self) -> Dict[str, Axes]:
        """``param_axes()`` flat, keyed like ``named_parameters()``."""
        return {f"{prefix}.{name}" if prefix else name: axes
                for prefix, m in self.named_modules()
                for name, axes in m._leaf_axes.items()
                if name in m._parameters}

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


def _leaf(t: torch.Tensor, axes: Optional[Axes],
          lead: Sequence[int]) -> nn.Parameter:
    """``t`` as a frozen parameter carrying its logical axes, if given (the
    layer-stack axes of ``lead`` are ``"layers"``)."""
    p = nn.Parameter(t, requires_grad=False)
    if axes is None:
        return p
    if len(axes) + len(lead) != t.dim():
        raise ValueError(f"axes {axes} do not name the dims of "
                         f"{tuple(t.shape)}")
    p.logical_axes = ("layers",) * len(lead) + tuple(axes)
    return p


def dense_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype,
               device, scale: Optional[float] = None,
               lead: Sequence[int] = (), *,
               axes: Optional[Axes] = None) -> nn.Parameter:
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
    return _leaf(t, axes, lead)


def ones_init(shape: Sequence[int], dtype, device,
              lead: Sequence[int] = (), *,
               axes: Optional[Axes] = None) -> nn.Parameter:
    return _leaf(torch.ones(tuple(lead) + tuple(shape), dtype=dtype,
                            device=device), axes, lead)


def zeros_init(shape: Sequence[int], dtype, device,
               lead: Sequence[int] = (), *,
               axes: Optional[Axes] = None) -> nn.Parameter:
    return _leaf(torch.zeros(tuple(lead) + tuple(shape), dtype=dtype,
                             device=device), axes, lead)


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
        kw = dict(dtype=dtype, device=device, lead=lead)
        self.wi = dense_init(gen, (d_model, d_ff), axes=("embed", "mlp"),
                             **kw)
        if act in ("swiglu", "geglu"):
            self.wg = dense_init(gen, (d_model, d_ff), axes=("embed", "mlp"),
                                 **kw)
        self.wo = dense_init(gen, (d_ff, d_model), axes=("mlp", "embed"),
                             **kw)


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
    h = constrain(h, ("dp", None, "tp"))
    return torch.einsum("...f,fd->...d", h, p["wo"])


# ----------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------
class Embedding(ParamTree):
    def __init__(self, vocab: int, d_model: int, tie: bool, *, dtype, device,
                 gen=None):
        super().__init__()
        # table: rows FSDP-sharded, d over the model axis
        self.tok = dense_init(gen, (vocab, d_model), dtype, device, scale=1.0,
                              axes=("vocab_gather", "embed_tp"))
        if not tie:
            self.head = dense_init(gen, (d_model, vocab), dtype, device,
                                   axes=("embed", "vocab"))


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of the table for ``tokens``.  A DTensor table is looked
    up on local shards: its rows gathered (the FSDP axes), its columns
    kept sharded, the tokens on their batch shards, so the backward's
    scatter into the table runs on plain tensors (DTensor's sharding
    rule for it fails on some torch releases); the table's gradient is a
    partial sum over the axes that shard the tokens."""
    tok = p["tok"]
    if not is_dtensor(tok):
        return tok[tokens.long()]
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh = tok.device_mesh
    tokens = replicated(tokens, mesh)
    tp, xp = kept_shards(tok, (1,)), kept_shards(tokens)
    if any(a.is_shard() and b.is_shard() for a, b in zip(tp, xp)):
        raise ValueError(f"a mesh axis shards both the table's columns "
                         f"and the tokens: {tp}, {xp}")
    grad = [Partial() if b.is_shard() else a for a, b in zip(tp, xp)]
    table = tok.redistribute(mesh, tp).to_local(grad_placements=grad)
    local = tokens.redistribute(mesh, xp).to_local()
    return DTensor.from_local(
        table[local.long()], mesh,
        [Shard(local.dim()) if a.is_shard() else b for a, b in zip(tp, xp)],
        run_check=False)


def unembed(p, x: torch.Tensor, tie: bool) -> torch.Tensor:
    if tie:
        # the table resharded (vocab to the model axis, d replicated)
        # instead of the logits
        w = constrain(p["tok"], ("vocab", None))
        return torch.einsum("...d,vd->...v", x, w)
    return torch.einsum("...d,dv->...v", x, p["head"])


# ----------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------
class _VocabParallelLseGold(torch.autograd.Function):
    """fp32 logsumexp and gold logit over a vocabulary sharded across
    ranks, on each rank's local logits (..., V_loc) whose first column is
    global column ``lo``: the local max, all-reduced (MAX) over
    ``groups``; the local sum of ``exp(x - max)``, all-reduced (SUM);
    ``lse = max + log(sum)``; the gold logit from the rank that holds the
    label's column (0 elsewhere), all-reduced (SUM).  The backward is
    local, ``softmax * d_lse + onehot * d_gold`` in the logits' dtype, from
    the saved local logits (no fp32 copy of them is kept)."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, groups):
        from torch.distributed import _functional_collectives as funcol
        v = logits.shape[-1]
        m = logits.amax(dim=-1).float()
        for g in groups:
            m = funcol.wait_tensor(funcol.all_reduce(m, "max", g))
        e = logits.to(torch.float32, copy=True)
        ssum = e.sub_(m[..., None]).exp_().sum(dim=-1)
        del e
        col = labels.clamp_min(0).long() - lo
        inside = (col >= 0) & (col < v)
        col = col.clamp(0, v - 1)[..., None]
        gold = torch.where(inside, torch.gather(logits, -1, col)[..., 0]
                           .float(), 0.0)
        for g in groups:
            ssum = funcol.wait_tensor(funcol.all_reduce(ssum, "sum", g))
            gold = funcol.wait_tensor(funcol.all_reduce(gold, "sum", g))
        lse = m + torch.log(ssum)
        ctx.save_for_backward(logits, lse, col, inside)
        return lse, gold

    @staticmethod
    def backward(ctx, d_lse, d_gold):
        logits, lse, col, inside = ctx.saved_tensors
        g = logits.to(torch.float32, copy=True)
        g.sub_(lse[..., None]).exp_()
        g.mul_(d_lse[..., None] if d_lse is not None else 0.0)
        if d_gold is not None:
            at = g.gather(-1, col) + torch.where(inside, d_gold, 0.0)[..., None]
            g = g.scatter(-1, col, at)
        return g.to(logits.dtype), None, None, None


def _lse_and_gold(logits: torch.Tensor, labels: torch.Tensor):
    """fp32 logsumexp over the vocab and the logit of each label (labels
    < 0 pick class 0; the caller masks them).  Under a mesh both run on
    each rank's shards of the logits, placed as the reference places them
    (batch over the data axes, vocab over ``"model"``), with the loss on
    each rank's batch shard (DTensor's gather backward would make its
    zeros at the global batch on every rank): a vocabulary sharded on a
    mesh axis of extent above 1 goes through ``_VocabParallelLseGold``,
    an unsharded one through the meshless formula."""
    logits = constrain(logits, ("dp", None, "tp"))
    if is_dtensor(logits):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        mesh = logits.device_mesh
        last = logits.dim() - 1
        pl = kept_shards(logits, (0, last))
        bp = kept_shards(logits)
        local = logits.redistribute(mesh, pl).to_local()
        lab = replicated(labels, mesh).redistribute(mesh, bp).to_local()
        groups = tuple((mesh, i) for i, p in enumerate(pl)
                       if p.is_shard(last))
        if groups:
            lo = compute_local_shape_and_global_offset(
                logits.shape, mesh, pl)[1][last]
            lse, gold = _VocabParallelLseGold.apply(local, lab, lo, groups)
        else:
            lse, gold = _lse_and_gold(local, lab)
        return (DTensor.from_local(lse, mesh, bp, run_check=False),
                DTensor.from_local(gold, mesh, bp, run_check=False))
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
