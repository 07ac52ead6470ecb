"""Mixture-of-Experts FFN in PyTorch, the JAX package's ``models/moe.py``.

Two implementations, as in the reference:

* ``scatter`` (the default): GShard-style capacity dispatch.  A stable sort
  of the routed rows by expert gives each row its rank inside its expert;
  rows past an expert's capacity are dropped (the earliest rows in
  token-major order are kept, as ``jnp.argsort``, which is stable, keeps
  them); the kept rows go into an ``(E, C, d)`` buffer (flat, with one
  zero row past it that collects the dropped ones), the experts run as
  batched products, and the rows come back weighted by their router
  weights.
* ``dense``: every expert on every token, combined by the router's
  weights; what reduced configs serve and the plain oracle of the tests.

* ``a2a`` (``moe_apply_a2a``): expert parallelism with explicit
  all-to-alls over the mesh's ``"model"`` process group, the reference's
  ``shard_map`` block on each rank's local tensors; without a mesh, a
  ``"model"`` extent above 1 or experts it divides, the scatter path.

Under a mesh (``launch.sharding``) the routing's ``sort``,
``searchsorted`` and ``index_put`` have no DTensor sharding rule, so the
block runs on local tensors.  The scatter path keeps the tokens on the
data axes and the experts on ``"model"``, as the reference's GSPMD
program does (``_scatter_on_shards``); the dense path, which serves only
reduced configs, gathers the tokens and the expert weights whole on
every rank (autograd carries the gathers) and returns a replicated
DTensor.  The reference's ``.at[].add`` dispatch is an ``index_put`` of
distinct slots here.

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

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..device import is_dtensor
from .layers import ParamTree, active_rules, dense_init

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


def _route(p, x2d: torch.Tensor, top_k: int):
    """(weights (T, k) fp32, experts (T, k) int64, probs (T, E) fp32)."""
    logits = torch.einsum("td,de->te", x2d.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, experts, probs


def _top1_share(experts: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The share of rows whose first choice is each expert: (E,) fp32."""
    return (experts[:, :1] == torch.arange(
        n_experts, device=experts.device)).float().mean(0)


def _router(p, x2d: torch.Tensor, top_k: int):
    """(weights (T, k) fp32, experts (T, k) int64, aux loss fp32 scalar)."""
    weights, experts, probs = _route(p, x2d, top_k)
    # load-balance aux loss (Switch eq. 4): E * sum_e f_e * P_e
    e = probs.shape[-1]
    aux = e * torch.sum(probs.mean(0) * _top1_share(experts, e))
    return weights, experts, aux


def capacity_of(tokens: int, top_k: int, n_experts: int,
                capacity_factor: float) -> int:
    """Slots per expert: the reference's arithmetic (Python ``round``),
    rounded up to a multiple of 128."""
    capacity = int(max(1, round(tokens * top_k / n_experts
                                * capacity_factor)))
    return -(-capacity // 128) * 128


def dispatch_slots(experts: torch.Tensor, capacity: int,
                   offset: Optional[torch.Tensor] = None):
    """For token-major routed rows ``experts`` (T, k): each row's expert
    (flat), its slot in that expert's buffer (``capacity`` for a dropped
    row) and whether it is kept.  A row's rank is its position among its
    expert's rows in a stable sort, so the earliest rows are kept; with
    ``offset`` (one count per expert index) the rows of each expert that
    come before these in the global token order are added to it."""
    expert_flat = experts.reshape(-1)
    srows = expert_flat.numel()
    sorted_e, order = torch.sort(expert_flat, stable=True)
    # first position of each row's expert in the sorted rows
    starts = torch.searchsorted(sorted_e, sorted_e)
    rank_sorted = torch.arange(srows, device=experts.device) - starts
    rank = torch.empty_like(rank_sorted).scatter(0, order, rank_sorted)
    if offset is not None:
        rank = rank + offset[expert_flat]
    keep = rank < capacity
    slot = torch.where(keep, rank, capacity)
    return expert_flat, slot, keep


def _dispatch(x2d: torch.Tensor, weights: torch.Tensor,
              experts: torch.Tensor, capacity: int, e0: int, e_loc: int,
              blocks: int = 1, offset: Optional[torch.Tensor] = None):
    """Each kept routed row of ``x2d`` (T, d) whose expert is one of
    ``e0 .. e0 + e_loc - 1`` into its own row of a buffer of ``blocks``
    capacity blocks: row ``(b * e_loc + e - e0) * c + slot % c`` with
    ``c = ceil(capacity / blocks)`` and block ``b = slot // c``.  Every
    other row (dropped, or bound for another expert) goes to the one row
    past them, which stays zero.  Returns the buffer's ``blocks * e_loc *
    c`` rows (``(E, C, d)`` flattened when ``blocks`` is 1 and
    ``e_loc`` is E), each row's flat index and its router weight (0 where
    not kept here)."""
    t, d = x2d.shape
    srows = weights.numel()
    w_flat = weights.reshape(srows).to(x2d.dtype)
    expert_flat, slot, keep = dispatch_slots(experts, capacity, offset)
    keep = keep & (expert_flat >= e0) & (expert_flat < e0 + e_loc)
    c = -(-capacity // blocks)
    n = blocks * e_loc * c
    rows = x2d.unsqueeze(1).expand(t, srows // t, d).reshape(srows, d)
    rows = torch.where(keep[:, None], rows, torch.zeros(
        (), dtype=x2d.dtype, device=x2d.device))
    flat = torch.where(keep, (slot // c * e_loc + expert_flat - e0) * c
                       + slot % c, n)
    buf = x2d.new_zeros((n + 1, d)).index_put((flat,), rows)
    return buf[:n], flat, w_flat * keep


def _combine(out: torch.Tensor, flat: torch.Tensor, w_kept: torch.Tensor,
             top_k: int) -> torch.Tensor:
    """Each token's rows of the expert outputs ``out`` (the dispatch
    buffer's rows, (n, d)), weighted and summed: (T, d).  A row not kept
    reads the zero row past them."""
    out = F.pad(out, (0, 0, 0, 1))
    gathered = out.index_select(0, flat) * w_kept[:, None]
    return gathered.reshape(-1, top_k, out.shape[-1]).sum(1)


def moe_apply_scatter(p, x: torch.Tensor, *, top_k: int, n_experts: int,
                      capacity_factor: float, act: str
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (B, S, d), aux loss."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    weights, experts, aux = _router(p, x2d, top_k)
    capacity = capacity_of(t, top_k, n_experts, capacity_factor)
    buf, flat, w_kept = _dispatch(x2d, weights, experts, capacity, 0,
                                  n_experts)
    out = _expert_ffn(p, buf.view(n_experts, capacity, d), act)
    y = _combine(out.reshape(-1, d), flat, w_kept, top_k)
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
    and DTensor redistributions).  Falls back to the scatter path
    (``scatter_apply``) where the reference does: no mesh, no ``"model"``
    axis, an extent of 1, or experts it does not divide."""
    rules = active_rules()
    mesh = getattr(rules, "mesh", None)
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    if mesh is None or "model" not in names \
            or rules.size("model") == 1 or n_experts % rules.size("model"):
        return scatter_apply(p, x, top_k=top_k, n_experts=n_experts,
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
    buf, flat, w_kept = _dispatch(x2d, weights, experts, cap, 0, n_experts)

    # dispatch: experts to their shard, capacities concatenated by source
    recv = all_to_all_single_autograd(buf.view(n_experts, cap, d), None,
                                      None, group)
    h_in = recv.reshape(tp, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, tp * cap, d)
    out = _expert_ffn({"wi": wi, "wg": wg, "wo": wo}, h_in, act)
    send = out.reshape(e_loc, tp, cap, d).transpose(0, 1).contiguous()
    back = all_to_all_single_autograd(send, None, None, group)
    y = _combine(back.reshape(n_experts * cap, d), flat, w_kept,
                 top_k).reshape(x_l.shape)

    y = DTensor.from_local(y, mesh, x_pl, run_check=False)
    # the mean of the ranks' losses: a sum of each over the mesh's size
    # (the gradient of a Partial's local value is the whole gradient of
    # the sum, so an "avg" reduction would hand each rank mesh.size()
    # times its share)
    aux = DTensor.from_local(aux / mesh.size(), mesh,
                             [Partial()] * mesh.ndim,
                             run_check=False).redistribute(mesh, rep)
    if "shared_wi" in p:
        y = y + _shared_ffn(p, x.reshape(b * s, d), act).reshape(x.shape)
    return y, aux


def _wait(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(t)


def scatter_apply(p, x: torch.Tensor, *, top_k: int, n_experts: int,
                  capacity_factor: float, act: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scatter path: ``moe_apply_scatter`` of a plain ``x``, and of a
    DTensor ``x`` on its mesh's shards (``_scatter_on_shards``)."""
    fn = _scatter_on_shards if is_dtensor(x) else moe_apply_scatter
    return fn(p, x, top_k=top_k, n_experts=n_experts,
              capacity_factor=capacity_factor, act=act)


def _scatter_on_shards(p, x: torch.Tensor, *, top_k: int, n_experts: int,
                       capacity_factor: float, act: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply_scatter`` of a DTensor ``x`` (B, S, d) with the tokens
    on the data axes, as the reference's GSPMD program shards it; every
    collective carries gradients (functional all-gathers and
    reduce-scatters, DTensor reductions), and one over a mesh extent of 1
    is not made, so a one-device mesh runs the meshless arithmetic.

    The flattened tokens are cut into one chunk per data rank, in order
    (its batch shard where the data axes divide the batch, else a slice of
    the whole), each chunk into one routing slice per ``"model"`` rank;
    chunks are padded with rows that route nowhere.  Each rank routes its
    slice; the ranks of a data chunk gather its choices and weights.  A
    routed row's rank within its expert is the number of that expert's
    rows in the data chunks before it (an all-gather of per-expert
    counts) plus its rank in its own chunk, so it is its position in the
    global token-major order and rows at or past ``capacity_of`` the
    global token count are dropped, as the reference drops them.  The
    Switch loss takes the global shares: per-expert sums reduced over
    every axis before their product.

    Rank ``(i, m)`` writes chunk ``i``'s kept rows bound for the experts of
    ``"model"`` rank ``m`` (``"ep"``) into a buffer of the whole capacity,
    cut into one block per data rank (``"cap"``): a reduce-scatter over
    the data axes leaves each rank its experts' block, ``(E / model,
    C / data, d)``, which its experts run with their FSDP weights gathered
    over the data axes.  An all-gather over the data axes brings the
    outputs back; each rank weights and sums its chunk's rows of its
    experts, and a reduction over ``"model"`` adds the experts' parts."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    sizes = [mesh.size(i) for i in range(mesh.ndim)]
    mdim = names.index("model") if "model" in names else None
    tp = sizes[mdim] if mdim is not None else 1
    ddims = [i for i in range(mesh.ndim) if i != mdim and sizes[i] > 1]
    n_dp, drank = 1, 0
    for i in ddims:
        n_dp *= sizes[i]
        drank = drank * sizes[i] + mesh.get_local_rank(i)
    mrank = mesh.get_local_rank(mdim) if tp > 1 else 0
    every = ddims + ([mdim] if tp > 1 else [])
    rep = [Replicate()] * mesh.ndim
    # a sum over every axis of extent above 1
    summed = [Partial() if i in every else Replicate()
              for i in range(mesh.ndim)]

    def placed(data, model=Replicate()):
        out = list(rep)
        for i in ddims:
            out[i] = data
        if tp > 1:
            out[mdim] = model
        return out

    if n_experts % tp:
        raise ValueError(f"{n_experts} experts on a model extent of {tp}")
    b, s, d = x.shape
    t = b * s
    # this data rank's chunk of the tokens; the gradient of each rank's
    # local tokens is a partial sum over "model": its routing slice and
    # its experts' rows
    by_batch = b % n_dp == 0
    if by_batch:
        x_in = placed(Shard(0))
        x_l = x.redistribute(mesh, x_in).to_local(
            grad_placements=placed(Shard(0), Partial())).reshape(-1, d)
        t_dp = valid = x_l.shape[0]
    else:
        x_in = rep
        x_l = x.redistribute(mesh, rep).to_local(
            grad_placements=placed(Partial(), Partial())).reshape(t, d)
        t_dp = -(-t // n_dp)
    t_r = -(-t_dp // tp)
    chunk = t_r * tp
    if not by_batch:
        if chunk * n_dp > t:
            x_l = F.pad(x_l, (0, 0, 0, chunk * n_dp - t))
        x_l = x_l[drank * chunk:(drank + 1) * chunk]
        valid = min(max(t - drank * chunk, 0), chunk)
    elif chunk > t_dp:
        x_l = F.pad(x_l, (0, 0, 0, chunk - t_dp))

    def whole(w):
        w = w if is_dtensor(w) else DTensor.from_local(w, mesh, rep,
                                                       run_check=False)
        return w.redistribute(mesh, rep).to_local(grad_placements=summed)

    # route this rank's slice; the aux loss from the global shares
    lo = mrank * t_r
    n_r = min(max(valid - lo, 0), t_r)
    weights, experts, probs = _route({"router": whole(p["router"])},
                                     x_l[lo:lo + t_r], top_k)
    if n_r:
        shares = torch.stack([
            probs[:n_r].mean(0), _top1_share(experts[:n_r], n_experts)
        ]) * (n_r / t)
    else:
        shares = probs.new_zeros((2, n_experts))
    if every:
        shares = DTensor.from_local(shares, mesh, summed, run_check=False
                                    ).redistribute(mesh, rep).to_local()
    aux = n_experts * torch.sum(shares[0] * shares[1])

    # the chunk's choices on each of its "model" ranks; padding rows
    # choose the expert past the last, which counts nowhere
    if tp > 1:
        weights = _wait(funcol.all_gather_tensor_autograd(
            weights, 0, (mesh, mdim)))
        experts = _wait(funcol.all_gather_tensor(experts, 0, (mesh, mdim)))
    if valid < chunk:
        experts = torch.where(
            torch.arange(chunk, device=experts.device)[:, None] < valid,
            experts, n_experts)
    offset = None
    if n_dp > 1:
        counts = torch.zeros(n_experts + 1, dtype=experts.dtype,
                             device=experts.device).scatter_add_(
            0, experts.reshape(-1), torch.ones_like(experts.reshape(-1)))
        counts = counts[None]
        for i in reversed(ddims):
            counts = _wait(funcol.all_gather_tensor(counts, 0, (mesh, i)))
        offset = counts[:drank].sum(0)

    # this "model" rank's experts and their weights
    e0, e1 = mrank * n_experts // tp, (mrank + 1) * n_experts // tp

    def experts_local(w):
        if not is_dtensor(w):
            w = DTensor.from_local(w, mesh, rep, run_check=False)
        return w.redistribute(mesh, placed(Replicate(), Shard(0))).to_local(
            grad_placements=placed(Partial(), Shard(0)))

    capacity = capacity_of(t, top_k, n_experts, capacity_factor)
    buf, flat, w_kept = _dispatch(x_l, weights, experts, capacity, e0,
                                  e1 - e0, n_dp, offset)
    for i in ddims:
        buf = _wait(funcol.reduce_scatter_tensor_autograd(
            buf, "sum", 0, (mesh, i)))
    ws = {k: experts_local(p[k]) for k in ("wi", "wg", "wo") if k in p}
    out = _expert_ffn(ws, buf.view(e1 - e0, -1, d), act).reshape(-1, d)
    for i in reversed(ddims):
        out = _wait(funcol.all_gather_tensor_autograd(out, 0, (mesh, i)))
    y = _combine(out, flat, w_kept, top_k)

    if not by_batch:
        y = DTensor.from_local(y, mesh, placed(Shard(0), Partial()),
                               run_check=False).redistribute(mesh, rep)
        y = y[:t].reshape(b, s, d)
    else:
        y = DTensor.from_local(y[:t_dp].reshape(-1, s, d), mesh,
                               placed(Shard(0), Partial()),
                               run_check=False).redistribute(mesh, x_in)
    if "shared_wi" in p:
        y = y + _shared_ffn(p, x.reshape(t, d), act).reshape(x.shape)
    return y, DTensor.from_local(aux, mesh, rep, run_check=False)


def moe_apply(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on ``cfg.moe_impl``: ``dense``, ``a2a``, else the scatter
    path; under a mesh, dense on replicated activations and scatter on the
    data shards of the tokens (``scatter_apply``)."""
    kwargs = dict(top_k=cfg.top_k, n_experts=cfg.n_experts, act=cfg.mlp_act)
    if cfg.moe_impl == "dense":
        return _on_replicated(moe_apply_dense, p, x, **kwargs)
    if cfg.moe_impl == "a2a":
        return moe_apply_a2a(p, x, capacity_factor=cfg.capacity_factor,
                             **kwargs)
    return scatter_apply(p, x, capacity_factor=cfg.capacity_factor,
                         **kwargs)
