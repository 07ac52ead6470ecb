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

* ``a2a`` (``moe_apply_a2a``): expert parallelism with explicit
  all-to-alls over the mesh's ``"model"`` process group, the reference's
  ``shard_map`` block on each rank's local tensors; without a mesh, a
  ``"model"`` extent above 1 or experts it divides, the scatter path.

Under a mesh (``launch.sharding``) the scatter and dense paths run on
replicated activations: the routing's ``sort``, ``searchsorted`` and
``index_put`` have no DTensor sharding rule, so the tokens and the expert
weights are gathered whole on every rank (autograd carries the
gathers), the block runs on plain tensors and its output is a replicated
DTensor.  The reference's ``.at[].add`` dispatch is an ``index_put`` of
distinct slots here, as in the meshless path.

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

from ..device import is_dtensor
from .layers import ParamTree, active_rules, constrain, dense_init

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
        self.router = dense_init(gen, (d_model, n_experts),
                                 axes=("embed", None), **kw)
        self.wi = dense_init(gen, (n_experts, d_model, d_ff),
                             axes=("experts", "embed", None), **kw)
        if gated:
            self.wg = dense_init(gen, (n_experts, d_model, d_ff),
                                 axes=("experts", "embed", None), **kw)
        self.wo = dense_init(gen, (n_experts, d_ff, d_model),
                             axes=("experts", None, "embed"), **kw)
        if n_shared:
            f = n_shared * d_ff
            self.shared_wi = dense_init(gen, (d_model, f),
                                        axes=("embed", "mlp"), **kw)
            if gated:
                self.shared_wg = dense_init(gen, (d_model, f),
                                            axes=("embed", "mlp"), **kw)
            self.shared_wo = dense_init(gen, (f, d_model),
                                        axes=("mlp", "embed"), **kw)


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


def _dispatch(x2d: torch.Tensor, weights: torch.Tensor,
              experts: torch.Tensor, capacity: int, n_experts: int):
    """Each kept routed row of ``x2d`` (T, d) into its own (expert, slot)
    of an (E, C + 1, d) buffer; the dropped rows are zeros, all bound for
    row C, which the experts never read.  Returns the buffer, each row's
    flat slot and its router weight (0 for a dropped row)."""
    t, d = x2d.shape
    srows = weights.numel()
    w_flat = weights.reshape(srows).to(x2d.dtype)
    expert_flat, slot, keep = dispatch_slots(experts, capacity)
    rows = x2d.unsqueeze(1).expand(t, srows // t, d).reshape(srows, d)
    rows = torch.where(keep[:, None], rows, torch.zeros(
        (), dtype=x2d.dtype, device=x2d.device))
    flat = expert_flat * (capacity + 1) + slot
    buf = x2d.new_zeros((n_experts * (capacity + 1), d)).index_put(
        (flat,), rows).reshape(n_experts, capacity + 1, d)
    return buf, flat, w_flat * keep


def _combine(out_e: torch.Tensor, flat: torch.Tensor, w_kept: torch.Tensor,
             top_k: int) -> torch.Tensor:
    """Each token's rows of the (E, C + 1, d) expert outputs, weighted and
    summed: (T, d)."""
    d = out_e.shape[-1]
    gathered = out_e.reshape(-1, d).index_select(0, flat) * w_kept[:, None]
    return gathered.reshape(-1, top_k, d).sum(1)


def moe_apply_scatter(p, x: torch.Tensor, *, top_k: int, n_experts: int,
                      capacity_factor: float, act: str
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (B, S, d), aux loss."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    weights, experts, aux = _router(p, x2d, top_k)
    capacity = capacity_of(t, top_k, n_experts, capacity_factor)
    buf, flat, w_kept = _dispatch(x2d, weights, experts, capacity,
                                  n_experts)
    buf = constrain(buf, ("ep", "cap", None))

    out_e = _expert_ffn(p, buf[:, :capacity], act)
    out_e = F.pad(out_e, (0, 0, 0, 1))
    out_e = constrain(out_e, ("ep", "cap", None))
    y = _combine(out_e, flat, w_kept, top_k)

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


def _replicated(t):
    """A DTensor's whole value on every rank (a differentiable gather), as
    a plain tensor; a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(placements=[Replicate()] * t.device_mesh.ndim
                          ).to_local()


def _on_replicated(fn, p, x, **kwargs):
    """``fn(p, x)`` of a DTensor ``x`` on whole tensors: x and the MoE
    leaves gathered, the block run on plain tensors, its output and aux
    loss returned as replicated DTensors."""
    if not is_dtensor(x):
        return fn(p, x, **kwargs)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    whole = {k: _replicated(p[k]) for k in _LEAVES if k in p}
    y, aux = fn(whole, _replicated(x), **kwargs)
    rep = [Replicate()] * mesh.ndim
    return (DTensor.from_local(y, mesh, rep, run_check=False),
            DTensor.from_local(aux, mesh, rep, run_check=False))


_LEAVES = ("router", "wi", "wg", "wo", "shared_wi", "shared_wg", "shared_wo")


def moe_apply_a2a(p, x: torch.Tensor, *, top_k: int, n_experts: int,
                  capacity_factor: float, act: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism with explicit all-to-all dispatch (the
    reference's ``shard_map`` block, on each rank's local tensors):

        local top-k / rank / scatter into (E, cap, d) -> all_to_all over
        "model" (E -> E/tp, cap -> tp·cap) -> expert weights gathered over
        the data axes (FSDP) -> local expert GEMMs -> all_to_all back ->
        local combine; aux averaged over every mesh axis.

    x is sharded over the data axes on the batch and over ``"model"`` on
    the sequence where they divide them; each shard's capacity is the
    reference's static local one, rounded up to a multiple of 8.  The
    collectives carry gradients (the autograd-aware functional all-to-all
    and DTensor redistributions).  Falls back to ``moe_apply_scatter`` where
    the reference does: no mesh, no ``"model"`` axis, an extent of 1, or
    experts it does not divide."""
    rules = active_rules()
    mesh = getattr(rules, "mesh", None)
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    if mesh is None or "model" not in names \
            or rules.size("model") == 1 or n_experts % rules.size("model"):
        return _on_replicated(moe_apply_scatter, p, x, top_k=top_k,
                              n_experts=n_experts,
                              capacity_factor=capacity_factor, act=act)
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    tp = rules.size("model")
    mdim = names.index("model")
    dp_dims = [i for i, a in enumerate(names) if a != "model"]
    n_dp = 1
    for i in dp_dims:
        n_dp *= mesh.size(i)
    group = mesh.get_group("model")

    b, s, d = x.shape
    # static local token count per (dp, tp) shard (seq over model)
    b_loc = b // n_dp if b % n_dp == 0 else b
    s_loc = s // tp if s % tp == 0 else s
    t_loc = b_loc * s_loc
    cap = int(max(1, round(t_loc * top_k / n_experts * capacity_factor)))
    cap = -(-cap // 8) * 8
    gated = act in GATED
    e_loc = n_experts // tp

    rep = [Replicate()] * mesh.ndim
    x_pl = list(rep)
    if b % n_dp == 0:
        for i in dp_dims:
            x_pl[i] = Shard(0)
    if s % tp == 0:
        x_pl[mdim] = Shard(1)
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, rep, run_check=False)
    x_l = x.redistribute(mesh, x_pl).to_local()
    # each rank's weight gradients cover its own tokens: partial sums
    # over every axis the tokens are spread on
    router = p["router"]
    if is_dtensor(router):
        router = router.redistribute(mesh, rep).to_local(
            grad_placements=[Partial()] * mesh.ndim)

    def experts_local(w):
        # FSDP-stored weights: experts over "model", gathered over the data
        # axes here, per layer
        if not is_dtensor(w):
            return w.chunk(tp, 0)[mesh.get_local_rank(mdim)]
        pl = list(rep)
        pl[mdim] = Shard(0)
        grad_pl = [Partial()] * mesh.ndim
        grad_pl[mdim] = Shard(0)
        return w.redistribute(mesh, pl).to_local(grad_placements=grad_pl)

    wi = experts_local(p["wi"])
    wg = experts_local(p["wg"]) if gated else None
    wo = experts_local(p["wo"])

    x2d = x_l.reshape(-1, d)
    weights, experts, aux = _router({"router": router}, x2d, top_k)
    buf, flat, w_kept = _dispatch(x2d, weights, experts, cap, n_experts)

    # dispatch: experts to their shard, capacities concatenated by source
    recv = all_to_all_single_autograd(buf[:, :cap].contiguous(), None, None,
                                      group)
    h_in = recv.reshape(tp, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, tp * cap, d)
    out = _expert_ffn({"wi": wi, "wg": wg, "wo": wo}, h_in, act)
    send = out.reshape(e_loc, tp, cap, d).transpose(0, 1).contiguous()
    back = all_to_all_single_autograd(send, None, None, group)
    out_e = F.pad(back.reshape(n_experts, cap, d), (0, 0, 0, 1))
    y = _combine(out_e, flat, w_kept, top_k).reshape(x_l.shape)

    y = DTensor.from_local(y, mesh, x_pl, run_check=False)
    aux = DTensor.from_local(aux, mesh, [Partial("avg")] * mesh.ndim,
                             run_check=False).redistribute(mesh, rep)
    if "shared_wi" in p:
        y = y + _shared_ffn(p, x.reshape(b * s, d), act).reshape(x.shape)
    return y, aux


def moe_apply(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on ``cfg.moe_impl``: ``dense``, ``a2a``, else the scatter
    path; under a mesh, dense and scatter on replicated activations."""
    kwargs = dict(top_k=cfg.top_k, n_experts=cfg.n_experts, act=cfg.mlp_act)
    if cfg.moe_impl == "dense":
        return _on_replicated(moe_apply_dense, p, x, **kwargs)
    if cfg.moe_impl == "a2a":
        return moe_apply_a2a(p, x, capacity_factor=cfg.capacity_factor,
                             **kwargs)
    return _on_replicated(moe_apply_scatter, p, x,
                          capacity_factor=cfg.capacity_factor, **kwargs)
