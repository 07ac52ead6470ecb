"""Mixture-of-Experts FFN in PyTorch, the JAX package's ``models/moe.py``.

Two implementations, as in the reference:

* ``scatter`` (the default): GShard-style capacity dispatch.  A stable sort
  of the routed rows by expert gives each row its rank inside its expert;
  rows past an expert's capacity are dropped (the earliest rows in
  token-major order are kept, as ``jnp.argsort``, which is stable, keeps
  them); the kept rows go into an ``(E, C + 1, d)`` buffer whose row ``C``
  collects the dropped ones, the experts run as batched products, and the
  rows come back weighted by their router weights.
* ``dense``: every expert on every token, combined by the router's
  weights; what reduced configs serve and the plain oracle of the tests.

``a2a`` runs ``moe_apply_scatter``: the port has no mesh, and the
reference's ``moe_apply_a2a`` itself falls back to the scatter path
without one.

Router: fp32 logits and softmax, top-k weights normalised to sum 1 (with
a 1e-9 floor), and the Switch load-balance auxiliary loss from the top-1
choices.

Every index operation here is one that PyTorch documents as deterministic
on a card under ``torch.use_deterministic_algorithms``, forward and
backward (``index_put`` without accumulation, ``scatter`` from a tensor,
``index_select``, ``searchsorted``, a stable ``sort``), and each writes out
of place, so a captured train step holds no mutation.  The expert products
are ``einsum``s (batched matrix products), as the reference leaves them to
XLA: no kernel of the JAX package sits on this path.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .layers import ParamTree, dense_init

GATED = ("swiglu", "geglu")


class MoE(ParamTree):
    """``init_moe``: ``router`` (d, E); ``wi``/``wg`` (E, d, f) and ``wo``
    (E, f, d); with ``n_shared`` experts also ``shared_wi``/``shared_wg``
    (d, n_shared f) and ``shared_wo`` (n_shared f, d).  Fan-in is each
    per-layer shape's first axis, as the reference's ``ParamBuilder``
    reads it (E for an expert stack)."""

    def __init__(self, d_model: int, n_experts: int, d_ff: int, act: str,
                 n_shared: int = 0, *, dtype, device, gen=None,
                 lead: Sequence[int] = ()):
        super().__init__()
        kw = dict(dtype=dtype, device=device, lead=lead)
        gated = act in GATED
        self.router = dense_init(gen, (d_model, n_experts), **kw)
        self.wi = dense_init(gen, (n_experts, d_model, d_ff), **kw)
        if gated:
            self.wg = dense_init(gen, (n_experts, d_model, d_ff), **kw)
        self.wo = dense_init(gen, (n_experts, d_ff, d_model), **kw)
        if n_shared:
            f = n_shared * d_ff
            self.shared_wi = dense_init(gen, (d_model, f), **kw)
            if gated:
                self.shared_wg = dense_init(gen, (d_model, f), **kw)
            self.shared_wo = dense_init(gen, (f, d_model), **kw)


def _gate(g: torch.Tensor, act: str) -> torch.Tensor:
    return F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")


def _expert_ffn(p, h_in: torch.Tensor, act: str) -> torch.Tensor:
    """h_in: (E, C, d) -> (E, C, d)."""
    h = torch.einsum("ecd,edf->ecf", h_in, p["wi"])
    if act in GATED:
        h = _gate(torch.einsum("ecd,edf->ecf", h_in, p["wg"]), act) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, p["wo"])


def _router(p, x2d: torch.Tensor, top_k: int):
    """(weights (T, k) fp32, experts (T, k) int64, aux loss fp32 scalar)."""
    logits = torch.einsum("td,de->te", x2d.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux loss (Switch eq. 4): E * sum_e f_e * P_e
    e = logits.shape[-1]
    me = probs.mean(0)
    one_hot_top1 = (experts[:, :1] == torch.arange(
        e, device=x2d.device)).float()
    ce = one_hot_top1.mean(0)
    aux = e * torch.sum(me * ce)
    return weights, experts, aux


def capacity_of(tokens: int, top_k: int, n_experts: int,
                capacity_factor: float) -> int:
    """Slots per expert: the reference's arithmetic (Python ``round``),
    rounded up to a multiple of 128."""
    capacity = int(max(1, round(tokens * top_k / n_experts
                                * capacity_factor)))
    return -(-capacity // 128) * 128


def dispatch_slots(experts: torch.Tensor, capacity: int):
    """For token-major routed rows ``experts`` (T, k): each row's expert
    (flat), its slot in that expert's buffer (``capacity`` for a dropped
    row) and whether it is kept.  A row's rank is its position among its
    expert's rows in a stable sort, so the earliest rows are kept."""
    expert_flat = experts.reshape(-1)
    srows = expert_flat.numel()
    sorted_e, order = torch.sort(expert_flat, stable=True)
    # first position of each row's expert in the sorted rows
    starts = torch.searchsorted(sorted_e, sorted_e)
    rank_sorted = torch.arange(srows, device=experts.device) - starts
    rank = torch.empty_like(rank_sorted).scatter(0, order, rank_sorted)
    keep = rank < capacity
    slot = torch.where(keep, rank, capacity)
    return expert_flat, slot, keep


def moe_apply_scatter(p, x: torch.Tensor, *, top_k: int, n_experts: int,
                      capacity_factor: float, act: str
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (B, S, d), aux loss."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    weights, experts, aux = _router(p, x2d, top_k)

    srows = t * top_k
    w_flat = weights.reshape(srows).to(x.dtype)
    capacity = capacity_of(t, top_k, n_experts, capacity_factor)
    expert_flat, slot, keep = dispatch_slots(experts, capacity)

    # dispatch: each kept row into its own (expert, slot) of an
    # (E, C + 1, d) buffer; the dropped rows are zeros, all bound for row
    # C, which the experts never read
    rows = x2d.unsqueeze(1).expand(t, top_k, d).reshape(srows, d)
    rows = torch.where(keep[:, None], rows, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
    flat = expert_flat * (capacity + 1) + slot
    buf = x.new_zeros((n_experts * (capacity + 1), d)).index_put(
        (flat,), rows).reshape(n_experts, capacity + 1, d)

    out_e = _expert_ffn(p, buf[:, :capacity], act)
    out_e = F.pad(out_e, (0, 0, 0, 1))

    # combine
    gathered = out_e.reshape(n_experts * (capacity + 1), d).index_select(
        0, flat) * (w_flat * keep)[:, None]
    y = gathered.reshape(t, top_k, d).sum(1)

    if "shared_wi" in p:
        y = y + _shared_ffn(p, x2d, act)
    return y.reshape(b, s, d), aux


def moe_apply_dense(p, x: torch.Tensor, *, top_k: int, n_experts: int,
                    act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference path: run every expert on every token (tiny configs
    only)."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    weights, experts, aux = _router(p, x2d, top_k)
    h = torch.einsum("td,edf->tef", x2d, p["wi"])
    if act in GATED:
        h = _gate(torch.einsum("td,edf->tef", x2d, p["wg"]), act) * h
    else:
        h = F.gelu(h, approximate="tanh")
    out_all = torch.einsum("tef,efd->ted", h, p["wo"])       # (T, E, d)
    # a token's k experts are distinct: each weight lands in its own cell
    mask = x.new_zeros((b * s, n_experts)).scatter(1, experts,
                                                   weights.to(x.dtype))
    y = torch.einsum("ted,te->td", out_all, mask)
    if "shared_wi" in p:
        y = y + _shared_ffn(p, x2d, act)
    return y.reshape(b, s, d), aux


def _shared_ffn(p, x2d: torch.Tensor, act: str) -> torch.Tensor:
    h = torch.einsum("td,df->tf", x2d, p["shared_wi"])
    if act in GATED:
        h = _gate(torch.einsum("td,df->tf", x2d, p["shared_wg"]), act) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("tf,fd->td", h, p["shared_wo"])


def moe_apply(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on ``cfg.moe_impl``: ``dense``, else the scatter path
    (``a2a`` included: no mesh, as the reference without one)."""
    kwargs = dict(top_k=cfg.top_k, n_experts=cfg.n_experts, act=cfg.mlp_act)
    if cfg.moe_impl == "dense":
        return moe_apply_dense(p, x, **kwargs)
    return moe_apply_scatter(p, x, capacity_factor=cfg.capacity_factor,
                             **kwargs)
