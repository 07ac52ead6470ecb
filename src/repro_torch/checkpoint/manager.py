"""Checkpointing: atomic, async, restore into the live state (the JAX
package's ``checkpoint/manager.py``, same layout and contract).

Layout (one directory per step):
    ckpt_dir/
      step_000120/
        meta.json                 — step, leaf paths, dtypes, shapes, data
                                    state
        shard_00000.npz           — this host's leaves (zstd when the
                                    zstandard module is there)
        COMMIT                    — written last; restore ignores dirs
                                    without it (atomicity marker)

Fault-tolerance contract:
  * `save` is all-or-nothing per step directory (COMMIT marker).
  * `save_async` runs on a background thread; at most one in flight —
    training overlaps the serialization.  It returns once the state is
    copied to host memory: the train step updates parameters and moments
    IN PLACE, so a step after it never changes what is saved.
  * `restore` with a `template` (the live state) copies each leaf into the
    template's tensor, on that tensor's device, and returns the template:
    the step goes on holding the same tensors.
  * `latest_step` + `keep` implement the restart loop's rolling window.

A state is a pytree of tensors (dicts, lists, tuples, NamedTuples such as
``AdamState``) whose nodes may also be ``torch.nn.Module``s (their
parameters, by name).  A DTensor leaf (a state on a device mesh) is saved
whole: every rank gathers it (a collective, so every rank of its mesh
saves at the same step) and the mesh's first rank writes it.  On a mesh
of several ranks the ranks then agree over the mesh: ``save`` returns on
no rank before the step is committed (``save_async``: ``wait``), a failed
write raises on every rank, and ``latest_step(template)`` and
``restore(template=)`` read the step the first rank sees, so every rank
resumes from the same one.  ``restore(template=)`` into a DTensor leaf
distributes the whole saved tensor onto that leaf's mesh and placements,
so a state saved on one mesh restores onto another (the reference's
elastic restore).  A ``HostShard`` leaf (moments in host memory on a mesh)
is saved whole as a DTensor is, and restored by writing each rank's slice
into the template's shard.  numpy has no
bfloat16: a bf16 leaf is stored as its raw 16-bit words and its dtype in
``meta.json``, and comes back bit for bit.  ``zstandard`` is optional, as in the reference; a checkpoint written
without it restores anywhere.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from ..device import is_dtensor
from ..launch.sharding import HostShard

try:
    import zstandard as _zstd
except Exception:  # pragma: no cover
    _zstd = None


def _leaves(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every leaf, a module's parameters by name."""
    flat, _ = pytree.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, torch.nn.Module))
    out = []
    for path, leaf in flat:
        key = "/".join(str(p) for p in path)
        if isinstance(leaf, torch.nn.Module):
            out += [(f"{key}/{n}", p) for n, p in leaf.named_parameters()]
        else:
            out.append((key, leaf))
    return out


def _sharded(t) -> bool:
    """Whether ``t`` is a shard of a mesh: a DTensor or a ``HostShard``."""
    return is_dtensor(t) or isinstance(t, HostShard)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy (bf16 as its 16-bit words); of a
    DTensor or a ``HostShard``, its whole value."""
    if _sharded(t):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _mesh_of(leaves: List[Tuple[str, torch.Tensor]]):
    """The mesh of the first DTensor or ``HostShard`` leaf, when it spans
    several ranks."""
    for _, t in leaves:
        if _sharded(t):
            return t.device_mesh if t.device_mesh.size() > 1 else None
    return None


def _writes(mesh) -> bool:
    """Whether this rank writes: the only one, or the mesh's first."""
    return mesh is None or int(mesh.mesh.flatten()[0]) == dist.get_rank()


def _from_writer(mesh, value: int) -> int:
    """The writing rank's ``value`` on every rank of ``mesh`` (a sum over
    the mesh to which only that rank adds): a broadcast, and a barrier."""
    if mesh is None:
        return value
    from torch.distributed.tensor import DTensor, Partial
    t = torch.tensor([value if _writes(mesh) else 0], dtype=torch.int64,
                     device=mesh.device_type)
    return int(DTensor.from_local(t, mesh, [Partial()] * mesh.ndim,
                                  run_check=False).full_tensor().item())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, host_id: int = 0,
                 n_hosts: int = 1):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        os.makedirs(directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None
        self._async_err: Optional[BaseException] = None
        self._async_mesh = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def latest_step(self, template: Any = None) -> Optional[int]:
        """The newest committed step, or None.  With a ``template`` on a
        mesh of several ranks, the one its first rank sees, on every
        rank."""
        mesh = None if template is None else _mesh_of(_leaves(template))
        if mesh is not None:
            seen = self.latest_step() if _writes(mesh) else None
            step = _from_writer(mesh, -1 if seen is None else seen)
            return None if step < 0 else step
        best = None
        for name in os.listdir(self.dir):
            if not name.startswith("step_"):
                continue
            d = os.path.join(self.dir, name)
            if not os.path.exists(os.path.join(d, "COMMIT")):
                continue  # incomplete (crashed mid-save)
            step = int(name.split("_")[1])
            best = step if best is None else max(best, step)
        return best

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any,
             extra_meta: Optional[Dict] = None) -> str:
        """Synchronous atomic save of a state."""
        mesh, snap = self._snapshot(state)
        try:
            d = self._write(step, snap, extra_meta)
        except BaseException as e:  # noqa: BLE001 - raised on every rank
            self._agree(mesh, e)
        self._agree(mesh, None)
        return d

    @staticmethod
    def _snapshot(state: Any):
        """The state's mesh (of several ranks, else None) and, on the rank
        that writes, its leaves on the host."""
        leaves = _leaves(state)
        mesh = _mesh_of(leaves)
        if not _writes(mesh):
            # this rank takes part in the gathers; the first rank writes
            for _, t in leaves:
                if _sharded(t):
                    t.full_tensor()
            return mesh, None
        return mesh, [(path, _dtype_name(t), _to_numpy(t))
                      for path, t in leaves]

    @staticmethod
    def _agree(mesh, err: Optional[BaseException]) -> None:
        """Wait for the writing rank of ``mesh``; raise its failure, on
        every rank."""
        failed = _from_writer(mesh, int(err is not None))
        if err is not None:
            raise err
        if failed:
            raise RuntimeError("the checkpoint write failed on the mesh's "
                               "first rank")

    def _write(self, step: int, snap: List[Tuple[str, str, np.ndarray]],
               extra_meta: Optional[Dict]) -> str:
        d = self._step_dir(step)
        if snap is None:
            return d
        tmp = d + f".tmp{self.host_id}"
        os.makedirs(tmp, exist_ok=True)
        buf_path = os.path.join(tmp, f"shard_{self.host_id:05d}.npz")
        np.savez(buf_path, **{f"leaf_{i}": a
                              for i, (_, _, a) in enumerate(snap)})
        if _zstd is not None:
            with open(buf_path, "rb") as src, \
                    open(buf_path + ".zst", "wb") as dst:
                _zstd.ZstdCompressor(level=1).copy_stream(src, dst)
            os.remove(buf_path)
        meta = {
            "step": step,
            "paths": [p for p, _, _ in snap],
            "dtypes": [dt for _, dt, _ in snap],
            "shapes": [list(a.shape) for _, _, a in snap],
            "n_hosts": self.n_hosts,
            "time": time.time(),
        }
        meta.update(extra_meta or {})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.isdir(d):
            shutil.rmtree(d)
        os.replace(tmp, d)
        with open(os.path.join(d, "COMMIT"), "w") as f:
            f.write(str(step))
        self._gc()
        return d

    def save_async(self, step: int, state: Any,
                   extra_meta: Optional[Dict] = None) -> None:
        """Background save; joins any previous in-flight save first.  The
        state is copied to host memory before this returns."""
        self.wait()
        mesh, snap = self._snapshot(state)
        self._async_mesh = mesh

        def work():
            try:
                self._write(step, snap, extra_meta)
            except BaseException as e:  # noqa: BLE001
                self._async_err = e

        self._async_thread = threading.Thread(target=work, daemon=True)
        self._async_thread.start()

    def wait(self) -> None:
        """Join the save in flight; on a mesh of several ranks, also wait
        for the writing rank's."""
        if self._async_thread is None:
            return
        self._async_thread.join()
        self._async_thread = None
        err, self._async_err = self._async_err, None
        self._agree(self._async_mesh, err)

    # ------------------------------------------------------------------
    def restore(self, step: Optional[int] = None, template: Any = None
                ) -> Tuple[Any, Dict]:
        """The state saved at ``step`` (default the latest committed) and
        its meta.  With ``template`` each leaf is copied into the
        template's tensor (same path, shape and dtype, else ValueError)
        and the template is returned; without, a list of CPU tensors."""
        step = step if step is not None else self.latest_step(template)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        buf_path = os.path.join(d, f"shard_{self.host_id:05d}.npz")
        if not os.path.exists(buf_path) and os.path.exists(buf_path + ".zst"):
            if _zstd is None:
                raise RuntimeError(f"{buf_path}.zst needs the zstandard "
                                   f"module to restore")
            # ranks restoring side by side each decompress, then rename
            part = f"{buf_path}.{os.getpid()}"
            with open(buf_path + ".zst", "rb") as src, \
                    open(part, "wb") as dst:
                _zstd.ZstdDecompressor().copy_stream(src, dst)
            os.replace(part, buf_path)
        with np.load(buf_path) as data:
            if template is None:
                return [_from_numpy(data[f"leaf_{i}"], dt) for i, dt in
                        enumerate(meta["dtypes"])], meta
            live = _leaves(template)
            if [p for p, _ in live] != meta["paths"]:
                raise ValueError(f"the template's leaves differ from step "
                                 f"{step}'s")
            with torch.no_grad():
                for i, ((path, t), dt) in enumerate(zip(live,
                                                        meta["dtypes"])):
                    src = _from_numpy(data[f"leaf_{i}"], dt)
                    if src.shape != t.shape or src.dtype != t.dtype:
                        raise ValueError(
                            f"{path}: saved {dt}{list(src.shape)}, live "
                            f"{_dtype_name(t)}{list(t.shape)}")
                    if isinstance(t, HostShard):
                        t.load_(src)
                    elif is_dtensor(t):
                        from torch.distributed.tensor import distribute_tensor
                        local = t.to_local()
                        local.copy_(distribute_tensor(
                            src.to(local.device), t.device_mesh,
                            t.placements, src_data_rank=None).to_local())
                    else:
                        t.copy_(src)
        return template, meta

    # ------------------------------------------------------------------
    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and os.path.exists(
                os.path.join(self.dir, n, "COMMIT")))
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
