"""Device meshes over ``torch.distributed`` (the JAX package's
``launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions, made over the default process group.  ``make_production_mesh``
is a FUNCTION, not a module constant: importing this module touches no
device and no process group.

``init_world(device)`` starts the default process group once per process:
from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) when one is set, else as a world of one (NCCL on a card,
gloo on the CPU) over a ``FileStore`` in a fresh temporary directory, so
that processes running side by side never meet on a port.  One process
drives one card: NCCL refuses two ranks on one device, so a single card
holds only a ``(1, 1)`` mesh.
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=60)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_world(device: Union[str, torch.device] = "cuda") -> int:
    """Start the default process group if none is running; returns the
    world size.  Under ``torchrun`` the rank's card is
    ``cuda:LOCAL_RANK``, made the current device."""
    device = torch.device(device)
    if dist.is_initialized():
        return dist.get_world_size()
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(_backend(device), init_method="env://",
                                timeout=TIMEOUT)
    else:
        path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_world_"),
                            "store")
        dist.init_process_group(_backend(device),
                                store=dist.FileStore(path, 1), rank=0,
                                world_size=1, timeout=TIMEOUT)
    return dist.get_world_size()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: Optional[str] = None):
    """A mesh of ``shape`` named ``axes`` over the first ``prod(shape)``
    ranks of the world (elastic re-meshing uses fewer ranks than the
    world).  A rank outside it gets ``None``."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    device = device or _device_type()
    n = 1
    for s in shape:
        n *= s
    if n == dist.get_world_size():
        return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))
    # every rank takes part in making the sub-groups
    mesh = DeviceMesh(device, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))
    return mesh if dist.get_rank() < n else None


def make_production_mesh(*, multi_pod: bool = False, device: Optional[str]
                         = None):
    """16 x 16 = 256 devices per pod; 2 pods = 512 devices multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(n_devices: Optional[int] = None, model: int = 2,
                   device: Optional[str] = None):
    """A small ``("data", "model")`` mesh over the world (the reference's
    ``len(jax.devices())`` is the world size here)."""
    n = n_devices or dist.get_world_size()
    model = min(model, n)
    return make_mesh((n // model, model), ("data", "model"), device)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes that shard the batch (everything except ``"model"``)."""
    return tuple(a for a in axis_names(mesh) if a != "model")
