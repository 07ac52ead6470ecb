"""Batched KV-block gather/scatter: one launch moves a whole block set.

The serving plane's batched data path (``ServingEngine`` under
``batch_transfers``) moves a cohort's cache rows in one launch per cache
leaf, over a 2-D row-pool view of the leaf:

* ``kv_block_gather(pool, idx)``         -> ``pool[idx]``  (K, W)
* ``kv_block_scatter(pool, idx, blocks)`` -> ``pool`` with rows ``idx``
  replaced by ``blocks``

On a CUDA tensor both launch the hand-written kernel of
``csrc/kv_block_copy.cu`` (it replaces the Pallas kernels ``kv_block_gather``
and ``kv_block_scatter`` of the JAX package's ``kernels/kv_block_copy.py``);
on a CPU tensor they run the plain versions of ``kernels/ref.py``.  Each
wrapper counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Union

import torch

from .ref import kv_block_gather_ref, kv_block_scatter_ref

Index = Union[torch.Tensor, Sequence[int]]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("kv_block_copy")
    lib.kv_block_copy_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.kv_block_copy_rows.restype = ctypes.c_int
    lib.kv_block_copy_error_string.argtypes = [ctypes.c_int]
    lib.kv_block_copy_error_string.restype = ctypes.c_char_p
    return lib


def _check_pool(pool: torch.Tensor, idx: Index) -> List[int]:
    """Validate the row pool and return ``idx`` as host ints in range.
    (A CUDA ``idx`` costs a device-to-host read; callers pass host ints.)"""
    if pool.dim() != 2:
        raise ValueError(f"pool must be 2-D (N, W), got {tuple(pool.shape)}")
    if not pool.is_contiguous():
        raise ValueError("pool must be contiguous: a reshape of a "
                         "non-contiguous leaf is a copy, and a scatter "
                         "into it would be lost")
    rows = idx.tolist() if torch.is_tensor(idx) else list(idx)
    rows = [int(i) for i in rows]
    n = pool.shape[0]
    for i in rows:
        if not 0 <= i < n:
            raise IndexError(f"row index {i} out of range for {n} rows")
    if len(rows) > 65535:
        raise ValueError(f"at most 65535 rows per launch, got {len(rows)}")
    return rows


def _device_index(rows: List[int], device: torch.device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _launch(src, src_idx, dst, dst_idx, k: int, row_bytes: int) -> None:
    lib = _lib()
    stream = torch.cuda.current_stream(dst.device).cuda_stream
    err = lib.kv_block_copy_rows(
        src.data_ptr(), src_idx.data_ptr() if src_idx is not None else None,
        dst.data_ptr(), dst_idx.data_ptr() if dst_idx is not None else None,
        k, row_bytes, stream)
    if err != 0:
        raise RuntimeError("kv_block_copy launch failed: "
                           + lib.kv_block_copy_error_string(err).decode())


def kv_block_gather(pool: torch.Tensor, idx: Index) -> torch.Tensor:
    """Rows ``idx`` of a contiguous 2-D row pool, ``(len(idx), W)``, in one
    launch.  Indices must be in range; duplicates are allowed."""
    rows = _check_pool(pool, idx)
    if pool.device.type == "cpu":
        return kv_block_gather_ref(pool, rows)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    out = torch.empty((len(rows), pool.shape[1]), dtype=pool.dtype,
                      device=pool.device)
    if not rows or pool.shape[1] == 0:
        return out
    with torch.cuda.device(pool.device):
        _launch(pool, _device_index(rows, pool.device), out, None,
                len(rows), pool.shape[1] * pool.element_size())
    kv_block_gather.launches += 1
    return out


def kv_block_scatter(pool: torch.Tensor, idx: Index,
                     blocks: torch.Tensor) -> torch.Tensor:
    """Write ``blocks[k]`` into row ``idx[k]`` of ``pool`` in one launch and
    return ``pool``; rows not in ``idx`` are untouched.

    The write is IN PLACE into the given pool (the JAX version returns a
    new array that aliases its input buffer).  The order of writes to a
    duplicated index is undefined, as in the JAX version."""
    rows = _check_pool(pool, idx)
    if blocks.shape != (len(rows), pool.shape[1]):
        raise ValueError(f"blocks must be {(len(rows), pool.shape[1])}, "
                         f"got {tuple(blocks.shape)}")
    if blocks.dtype != pool.dtype or blocks.device != pool.device:
        raise ValueError("blocks must match the pool's dtype and device")
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    if pool.device.type == "cpu":
        return kv_block_scatter_ref(pool, rows, blocks)
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    if not rows or pool.shape[1] == 0:
        return pool
    with torch.cuda.device(pool.device):
        _launch(blocks, None, pool, _device_index(rows, pool.device),
                len(rows), pool.shape[1] * pool.element_size())
    kv_block_scatter.launches += 1
    return pool


kv_block_gather.launches = 0
kv_block_scatter.launches = 0
