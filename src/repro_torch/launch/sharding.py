"""Logical-axis -> mesh-axis resolution (the JAX package's
``launch/sharding.py``), over DTensor placements.

Model code names the axes of its parameters and activations with
*logical* names; ``MeshRules`` resolves them against a mesh with the
reference's table and per-arch fallbacks:

    embed       -> FSDP axes (the batch axes) when fsdp, else replicated
    heads       -> "model" iff n_heads % model_size == 0, else replicated
    kv_heads    -> "model" iff n_kv_heads % model_size == 0, else replicated
    mlp / vocab / experts / ssm_inner / ssm_conv -> "model"
    vocab_gather-> embedding-table rows over the FSDP axes
    dp          -> batch axes; tp / ep / kv_seq -> "model"
    layers      -> never sharded (the stacked-layer axis)

``spec(logical)`` gives the mesh axes of each tensor dimension (the parts
of the reference's ``PartitionSpec``); ``placements(logical)`` turns them
into one DTensor placement per mesh dimension.  A tensor dimension mapped
onto several mesh axes (FSDP over ``("pod", "data")``) is ``Shard(dim)``
on each of them, the first mesh dimension the major one, as in the
reference.  ``shardings_for`` replicates a dimension that its mesh extent
does not divide: DTensor would shard it unevenly without complaint.

A ``Sharding`` of memory kind ``"pinned_host"`` (the reference's
``with_memory_kind``) places a tensor as a ``HostShard``: the rank's local
shard in host memory with the mesh, placements, shape and stride of the
DTensor it stands for (the optimizer moments between steps under
``offload_opt_state``).

``constrain(x, logical)`` redistributes a DTensor activation (a plain
tensor passes through); ``use_rules(rules)`` installs the rules for the
model code's ``layers.constrain``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from ..models import layers as _layers
from ..device import is_dtensor
from .mesh import axis_names


MEMORY_KINDS = ("device", "pinned_host")


class Sharding(NamedTuple):
    """A mesh, one placement per mesh dimension and a memory kind (the
    port's ``NamedSharding``): ``"device"`` places a tensor as a DTensor,
    ``"pinned_host"`` as a ``HostShard``."""
    mesh: Any
    placements: Tuple[Any, ...]
    memory_kind: str = "device"

    @classmethod
    def of(cls, t) -> "Sharding":
        """The sharding of a DTensor or a ``HostShard``."""
        if isinstance(t, HostShard):
            return t.sharding
        return cls(t.device_mesh, tuple(t.placements))

    def with_memory_kind(self, kind: str) -> "Sharding":
        if kind not in MEMORY_KINDS:
            raise ValueError(f"memory kind {kind!r}: one of {MEMORY_KINDS}")
        return self._replace(memory_kind=kind)

    def distribute(self, t):
        """``t`` (a whole tensor that every rank holds, a DTensor or a
        ``HostShard``) placed by this sharding."""
        if self.memory_kind == "pinned_host":
            return HostShard.place(t, self)
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh, self.placements)


def _is_sharding(x) -> bool:
    return isinstance(x, Sharding)


def local_slice(whole: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``whole`` (a view) under ``placements`` on
    ``mesh``: what ``distribute_tensor(whole, ..., src_data_rank=None)``
    holds locally, sliced where ``whole`` lies."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    shape, offset = compute_local_shape_and_global_offset(
        whole.shape, mesh, placements)
    return whole[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def host_empty(shape, dtype: torch.dtype, device_type: str) -> torch.Tensor:
    """An empty host tensor for a shard of a mesh on ``device_type``:
    pinned for a card (raises where there is none), plain for the CPU."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=device_type != "cpu")


class HostShard:
    """This rank's shard of a tensor on a device mesh, kept in host memory:
    the port's array of memory kind ``pinned_host`` (DTensor has no memory
    kind, and ``DTensor.from_local`` moves a host tensor to the mesh's
    device).  ``local`` is pinned when the mesh is on a card and a plain
    CPU tensor when it is on the CPU; ``device_mesh``, ``placements``,
    ``shape`` and ``stride`` are the DTensor's it stands for.  It is not a
    tensor, so no operator takes it for a whole replicated value:
    ``fetch`` makes the shard a DTensor on the mesh's device, and
    ``full_tensor`` gathers the whole value."""
    __slots__ = ("local", "device_mesh", "placements", "shape", "_stride")

    def __init__(self, local: torch.Tensor, device_mesh, placements,
                 shape, stride):
        self.local = local
        self.device_mesh = device_mesh
        self.placements = tuple(placements)
        self.shape = torch.Size(shape)
        self._stride = tuple(stride)

    @classmethod
    def place(cls, t, sharding: Sharding) -> "HostShard":
        """``t`` (a whole tensor every rank holds, a DTensor or a
        ``HostShard``) as this rank's shard under ``sharding``; a host
        shard already so placed is returned as it is."""
        mesh, placements = sharding.mesh, tuple(sharding.placements)
        if isinstance(t, HostShard):
            if t.device_mesh == mesh and t.placements == placements:
                return t
            t = t.full_tensor()
        if is_dtensor(t):
            if t.device_mesh != mesh or tuple(t.placements) != placements:
                t = t.redistribute(mesh, placements)
            shape, stride, local = t.shape, t.stride(), t.to_local()
        else:
            shape, stride = t.shape, t.stride()
            local = local_slice(t, mesh, placements)
        host = host_empty(local.shape, local.dtype, mesh.device_type)
        host.copy_(local)
        return cls(host, mesh, placements, shape, stride)

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def sharding(self) -> Sharding:
        return Sharding(self.device_mesh, self.placements, "pinned_host")

    def numel(self) -> int:
        return self.shape.numel()

    def element_size(self) -> int:
        return self.local.element_size()

    def fetch(self, device=None):
        """The shard as a DTensor on ``device`` (default: the mesh's), its
        local tensor copied there without blocking (on the CPU, the host
        tensor itself)."""
        from torch.distributed.tensor import DTensor
        if device is None:
            device = torch.device(self.device_mesh.device_type)
        return DTensor.from_local(
            self.local.to(device, non_blocking=True), self.device_mesh,
            self.placements, run_check=False, shape=self.shape,
            stride=self._stride)

    def full_tensor(self) -> torch.Tensor:
        """The whole value on the mesh's device: a gather over the mesh,
        which every rank of it makes together."""
        return self.fetch().full_tensor()

    def load_(self, whole: torch.Tensor) -> "HostShard":
        """Write this rank's slice of ``whole`` into the shard."""
        self.local.copy_(local_slice(whole, self.device_mesh,
                                     self.placements))
        return self

    def __repr__(self) -> str:
        return (f"HostShard(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"local={tuple(self.local.shape)}, "
                f"placements={self.placements})")


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def _names(m) -> Tuple[str, ...]:
    return (m,) if isinstance(m, str) else tuple(m or ())


@dataclasses.dataclass
class MeshRules:
    mesh: Any
    cfg: Any = None
    fsdp: bool = True
    # Megatron-style sequence sharding of inter-block activations over the
    # model axis
    act_seq_shard: bool = False

    def __post_init__(self):
        names = axis_names(self.mesh)
        self.model_axis = "model" if "model" in names else None
        self.batch_axes = tuple(a for a in names if a != "model")
        msize = self.size("model") if self.model_axis else 1
        fsdp_axes = self.batch_axes if self.fsdp else None
        cfg = self.cfg

        def fits(n: Optional[int]) -> bool:
            return bool(n) and msize > 0 and n % msize == 0

        self.table: Dict[Optional[str], Any] = {
            None: None,
            "embed": fsdp_axes,
            "embed_tp": "model",
            "mlp": "model",
            "vocab": "model",
            "vocab_gather": fsdp_axes,
            "experts": "model",
            "ssm_inner": "model",
            "ssm_conv": "model",
            "ssm_proj": None,
            "heads": "model" if (cfg is None or fits(cfg.n_heads)) else None,
            "kv_heads": "model" if (cfg is None or fits(cfg.n_kv_heads))
                        else None,
            "layers": None,
            # activation logical axes
            "dp": self.batch_axes,
            # "tp" is used on mlp-hidden / logits (always divisible)
            "tp": "model",
            "tp_kv": "model" if (cfg is None or fits(cfg.n_kv_heads))
                     else None,
            "ep": "model",
            "cap": self.batch_axes,   # MoE capacity dim over data axes
            "kv_seq": "model",
            "seq": "model" if self.act_seq_shard else None,
        }
        self.table["act_heads"] = (
            None if cfg is not None and not fits(cfg.n_heads) else "model")

    # ------------------------------------------------------------------
    def size(self, axis: str) -> int:
        return self.mesh.size(axis_names(self.mesh).index(axis))

    def _extent(self, m) -> int:
        n = 1
        for a in _names(m):
            n *= self.size(a)
        return n

    def spec(self, logical: Tuple[Optional[str], ...]) -> Tuple[Any, ...]:
        """The mesh axes of each dimension (a ``PartitionSpec``'s parts)."""
        return tuple(self.table.get(name, None) for name in logical)

    def _placements(self, parts) -> Tuple[Any, ...]:
        from torch.distributed.tensor import Replicate, Shard
        names = axis_names(self.mesh)
        out = [Replicate()] * len(names)
        for dim, m in enumerate(parts):
            for a in _names(m):
                out[names.index(a)] = Shard(dim)
        return tuple(out)

    def placements(self, logical: Tuple[Optional[str], ...]
                   ) -> Tuple[Any, ...]:
        return self._placements(self.spec(logical))

    def sharding(self, logical: Tuple[Optional[str], ...]) -> Sharding:
        return Sharding(self.mesh, self.placements(logical))

    def param_shardings(self, axes_tree):
        """An axes tree (tuples of logical names) -> ``Sharding``s."""
        return pytree.tree_map(self.sharding, axes_tree,
                               is_leaf=_is_axes_leaf)

    def _fitted(self, logical, shape) -> Tuple[Any, ...]:
        parts = []
        for dim, name in zip(shape, logical):
            m = self.table.get(name, None)
            size = self._extent(m)
            parts.append(m if size > 1 and dim % size == 0 else None)
        return tuple(parts)

    def shardings_for(self, axes_tree, shape_tree):
        """Like ``param_shardings``, validated against concrete shapes (any
        tensors or ``torch.Size``s): a logical axis whose mesh extent does
        not divide the dimension falls back to replicated."""
        axes_flat, spec = pytree.tree_flatten(axes_tree, is_leaf=_is_axes_leaf)
        shapes = [tuple(getattr(s, "shape", s)) for s in
                  pytree.tree_flatten(shape_tree, is_leaf=lambda x: isinstance(
                      x, torch.Size))[0]]
        if len(shapes) != len(axes_flat):
            raise ValueError(f"{len(axes_flat)} axes leaves for "
                             f"{len(shapes)} shapes")
        return pytree.tree_unflatten(
            [Sharding(self.mesh, self._placements(self._fitted(a, s)))
             for a, s in zip(axes_flat, shapes)], spec)

    def batch_sharding(self, batch):
        """``Shard(0)`` over the batch axes for a leaf whose leading
        dimension they divide, else replicated."""
        n = self.n_batch_shards

        def leaf(s):
            shape = tuple(s.shape)
            first = self.batch_axes if (shape and n > 1
                                        and shape[0] % n == 0) else None
            return Sharding(self.mesh, self._placements(
                (first,) + (None,) * (len(shape) - 1)))
        return pytree.tree_map(leaf, batch)

    def constrain(self, x, logical):
        """Redistribute a DTensor to the mapping of ``logical`` (names whose
        mesh extent does not divide the dimension are dropped, and so are
        extents of 1, which shard nothing); a plain tensor is returned as
        it is."""
        if not is_dtensor(x):
            return x
        placements = self._placements(self._fitted(logical, x.shape))
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(self.mesh, placements)

    def replicated(self) -> Sharding:
        return Sharding(self.mesh, self._placements(()))

    @property
    def n_batch_shards(self) -> int:
        return self._extent(self.batch_axes)


def shard_params(params: torch.nn.Module, rules: MeshRules
                 ) -> torch.nn.Module:
    """Replace each plain parameter of ``params`` (a ``ParamTree``) IN
    PLACE by a DTensor parameter on ``rules``' mesh, placed by the logical
    axes the tree records (``shardings_for``: a dimension its mesh extent
    does not divide stays whole).  Every rank must hold the same values; a
    parameter already a DTensor stays as it is.  Returns ``params``."""
    axes = params.named_param_axes()
    for name, p in list(params.named_parameters()):
        if is_dtensor(p):
            continue
        sharding = rules.shardings_for(axes[name], p.shape)
        *parent, leaf = name.split(".")
        owner = params.get_submodule(".".join(parent))
        with torch.no_grad():
            d = sharding.distribute(p.detach())
        setattr(owner, leaf, torch.nn.Parameter(d, requires_grad=False))
    return params


def local_params(params: torch.nn.Module, shell: torch.nn.Module
                 ) -> torch.nn.Module:
    """``shell`` (a ``meta`` parameter module of the same structure) holding
    the local shards of ``params``' DTensors (plain leaves as they are),
    sharing their storage: on a one-device mesh, the whole tensors."""
    state = {k: (p.to_local() if is_dtensor(p) else p).detach()
             for k, p in params.named_parameters()}
    shell.load_state_dict(state, strict=True, assign=True)
    for p in shell.parameters():
        p.requires_grad_(False)
    return shell


@contextlib.contextmanager
def use_rules(rules: Optional[MeshRules]):
    """Install activation-constraint rules for model code."""
    _layers.set_active_rules(rules)
    try:
        yield rules
    finally:
        _layers.set_active_rules(None)
