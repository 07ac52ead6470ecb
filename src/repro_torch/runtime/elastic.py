"""Elastic scaling: re-mesh and re-shard a live training state (the JAX
package's ``runtime/elastic.py``).

When the fleet grows or shrinks (preemptions, capacity changes, straggler
eviction), the coordinator rebuilds the mesh over the surviving ranks and
the training state must follow.  ``reshard_state`` moves every DTensor
leaf onto the new mesh's placements: through the whole tensor where the
meshes differ in size (every rank of the old mesh takes part in the
gather; a rank outside a smaller new mesh holds nothing afterwards), by
re-wrapping the local shards where they match.  With
``CheckpointManager.restore(template=)`` it also covers restarting on a
new topology.

``plan_elastic_mesh`` picks the largest (data x model) grid that keeps the
model-parallel degree when it can (a TP change forces a weight re-layout;
a DP change only re-slices the batch).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from ..device import is_dtensor
from ..launch.sharding import MeshRules, _is_axes_leaf


@dataclasses.dataclass
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    kept_model_degree: bool
    dp_degree: int
    tp_degree: int


def plan_elastic_mesh(n_devices: int, prev_tp: int) -> ElasticPlan:
    """Largest usable grid: keep TP degree if it divides the new world,
    else the largest power-of-two TP that fits."""
    tp = prev_tp if n_devices % prev_tp == 0 else _largest_pow2_divisor(
        n_devices, prev_tp)
    dp = n_devices // tp
    return ElasticPlan(mesh_shape=(dp, tp), axes=("data", "model"),
                       kept_model_degree=(tp == prev_tp),
                       dp_degree=dp, tp_degree=tp)


def _largest_pow2_divisor(n: int, cap: int) -> int:
    t = 1
    while t * 2 <= cap and n % (t * 2) == 0:
        t *= 2
    return t


def _moved(x: torch.Tensor, sharding) -> Optional[torch.Tensor]:
    """``x`` (a DTensor or a plain whole tensor) on ``sharding``; None for
    a rank outside the new mesh."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if sharding is not None and is_dtensor(x) \
            and torch.equal(x.device_mesh.mesh, sharding.mesh.mesh) \
            and tuple(x.placements) == tuple(sharding.placements):
        return DTensor.from_local(x.to_local(), sharding.mesh,
                                  sharding.placements, run_check=False)
    whole = x.full_tensor() if is_dtensor(x) else x
    if sharding is None:
        return None
    return distribute_tensor(whole, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def reshard_state(state: Any, axes_tree: Any, new_mesh, cfg=None,
                  fsdp: bool = True) -> Tuple[Any, Optional[MeshRules]]:
    """Move a pytree of tensors onto ``new_mesh`` (``None`` on a rank
    outside it), each leaf placed by its logical axes in ``axes_tree``
    (same structure, ``shardings_for``'s divisibility fallback).  Returns
    ``(state, new rules)``; outside the new mesh, leaves and rules are
    None."""
    leaves, spec = pytree.tree_flatten(state)
    axes = pytree.tree_flatten(axes_tree, is_leaf=_is_axes_leaf)[0]
    if len(axes) != len(leaves):
        raise ValueError(f"{len(axes)} axes leaves for {len(leaves)} "
                         f"state leaves")
    rules = None
    shardings = [None] * len(leaves)
    if new_mesh is not None:
        rules = MeshRules(new_mesh, cfg=cfg, fsdp=fsdp)
        shardings = [rules.shardings_for(a, x.shape)
                     for a, x in zip(axes, leaves)]
    return pytree.tree_unflatten(
        [_moved(x, s) for x, s in zip(leaves, shardings)], spec), rules
