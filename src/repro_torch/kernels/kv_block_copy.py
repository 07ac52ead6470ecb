"""Batched KV-block gather/scatter: one launch moves a whole block set.

The serving plane's batched data path (``ServingEngine`` under
``batch_transfers``) moves a cohort's cache rows of every cache leaf in one
launch each way.  Three forms, one kernel:

* ``kv_block_gather(pool, idx)`` -> ``pool[idx]``, ``(K, W)``, for a
  contiguous 2-D row pool (the JAX package's contract);
* ``kv_block_gather(leaf, idx, axis=a)`` -> the slots ``idx`` of a
  contiguous cache leaf whose slot is on axis ``a``, as a contiguous
  ``(K, *shape[:a], *shape[a+1:])`` tensor: what the JAX engine gets from
  ``moveaxis(leaf, a, 0).reshape(N, -1)[idx]`` and reshapes;
* ``kv_block_gather(leaves, idx, axis=[a0, a1, ...])`` -> the list of those,
  for up to ``MAX_LEAVES`` leaves of any dtypes, in ONE launch.

``kv_block_scatter(pool | leaf | leaves, idx, blocks, axis=...)`` writes
blocks of those shapes back in place, in one launch, and returns its first
argument.  A leaf is read or written through its layout: nothing copies it.

On a CUDA tensor both launch the hand-written kernel of
``csrc/kv_block_copy.cu`` (it replaces the Pallas kernels ``kv_block_gather``
and ``kv_block_scatter`` of the JAX package's ``kernels/kv_block_copy.py``);
on a CPU tensor they run the plain versions of ``kernels/ref.py``.  Each
wrapper counts its kernel launches in ``.launches``.  The up to
``MAX_ROWS`` indices travel in the kernel's parameter block, as the Pallas
kernels' scalar prefetch: a call uploads nothing and never waits for the
device.  Indices are host ints (a CUDA ``idx`` costs a device-to-host
read); duplicates are allowed, and a scatter's order of writes to a
duplicated index is undefined, as in the JAX version.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import List, Optional, Sequence, Tuple, Union

import torch

from .ref import kv_block_gather_ref, kv_block_scatter_ref

Index = Union[torch.Tensor, Sequence[int]]
Leaves = Union[torch.Tensor, Sequence[torch.Tensor]]
Axis = Union[None, int, Sequence[Optional[int]]]

MAX_ROWS = 512     # the kernel's parameter block holds K int32 indices
MAX_LEAVES = 16    # and this many leaf descriptors, under 4 KB


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("kv_block_copy")
    lib.kv_block_copy.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_void_p]
    lib.kv_block_copy.restype = ctypes.c_int
    lib.kv_block_copy_error_string.argtypes = [ctypes.c_int]
    lib.kv_block_copy_error_string.restype = ctypes.c_char_p
    return lib


# (outer, N, segment bytes, gathered shape) of one leaf
Layout = Tuple[int, int, int, Tuple[int, ...]]


def _rows(idx: Index) -> List[int]:
    rows = idx.tolist() if torch.is_tensor(idx) else [int(i) for i in idx]
    if len(rows) > MAX_ROWS:
        raise ValueError(f"at most MAX_ROWS = {MAX_ROWS} rows per launch "
                         f"(the kernel's parameter block), got {len(rows)}")
    return rows


def _layouts(pool: Leaves, axis: Axis, k: int
             ) -> Tuple[bool, List[torch.Tensor], List[Layout], int]:
    """Validate the leaves; return (one tensor given, leaves, their
    layouts, device index: -1 for the CPU)."""
    single = torch.is_tensor(pool)
    leaves = [pool] if single else list(pool)
    if not leaves or len(leaves) > MAX_LEAVES:
        raise ValueError(f"1 to MAX_LEAVES = {MAX_LEAVES} leaves per launch, "
                         f"got {len(leaves)}")
    if axis is None or isinstance(axis, int):
        axes = [axis] * len(leaves)
    else:
        axes = list(axis)
        if len(axes) != len(leaves):
            raise ValueError(f"{len(axes)} axes for {len(leaves)} leaves")
    first = leaves[0]
    if not (first.is_cuda or first.is_cpu):
        raise ValueError(f"unsupported device {first.device}")
    dev = first.get_device()
    out = []
    for leaf, a in zip(leaves, axes):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if a is None:
            if nd != 2:
                raise ValueError(f"pool must be 2-D (N, W), got {shape}")
            a = 0
        elif not -nd <= a < nd:
            raise ValueError(f"axis {a} out of range for a leaf of {shape}")
        elif a < 0:
            a += nd
        if not leaf.is_contiguous():
            raise ValueError("leaf must be contiguous: a reshape of a "
                             "non-contiguous leaf is a copy, and a scatter "
                             "into it would be lost")
        if leaf.get_device() != dev:
            raise ValueError("leaves must all lie on the CPU or all on one "
                             f"CUDA device, got {leaf.device}")
        rest = shape[a + 1:]
        out.append((math.prod(shape[:a]), shape[a],
                    math.prod(rest) * leaf.element_size(),
                    (k,) + shape[:a] + rest))
    return single, leaves, out, dev


def _check_range(rows: List[int], layouts: List[Layout]) -> None:
    n = min(lay[1] for lay in layouts)
    if rows and (min(rows) < 0 or max(rows) >= n):
        bad = next(i for i in rows if not 0 <= i < n)
        raise IndexError(f"row index {bad} out of range for {n} rows")


def _launch(gather: bool, leaves: List[torch.Tensor],
            bufs: List[torch.Tensor], layouts: List[Layout], rows: List[int],
            dev: int) -> bool:
    """One launch moving ``rows`` of every leaf to (gather) or from its
    buffer, on the current stream.  Returns False, launching nothing, when
    there is nothing to move."""
    if not rows or not any(outer and seg for outer, _, seg, _ in layouts):
        return False
    if dev != torch._C._cuda_getDevice():
        raise ValueError(f"leaves lie on cuda:{dev}, not on the current "
                         "device")
    words = []
    for leaf, buf, (outer, n, seg, _) in zip(leaves, bufs, layouts):
        words += (leaf.data_ptr(), buf.data_ptr(), outer, n, seg)
    lib = _lib()
    err = lib.kv_block_copy(
        int(gather), len(leaves), struct.pack(f"{len(words)}q", *words),
        len(rows), struct.pack(f"{len(rows)}i", *rows),
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError("kv_block_copy launch failed: "
                           + lib.kv_block_copy_error_string(err).decode())
    return True


def kv_block_gather(pool: Leaves, idx: Index, *, axis: Axis = None):
    """Rows ``idx`` of a 2-D pool (``axis`` None), of a leaf with its slot
    on ``axis``, or of each of a list of leaves (``axis`` one int or one
    per leaf), in one launch.  Indices must be in range."""
    rows = _rows(idx)
    single, leaves, layouts, dev = _layouts(pool, axis, len(rows))
    _check_range(rows, layouts)
    if dev < 0:
        return kv_block_gather_ref(pool if single else leaves, rows,
                                   axis=axis)
    outs = [leaf.new_empty(lay[3]) for leaf, lay in zip(leaves, layouts)]
    if _launch(True, leaves, outs, layouts, rows, dev):
        kv_block_gather.launches += 1
    return outs[0] if single else outs


def kv_block_scatter(pool: Leaves, idx: Index, blocks: Leaves, *,
                     axis: Axis = None):
    """Write ``blocks`` (what ``kv_block_gather(pool, idx, axis=axis)``
    returns, in shape, dtype and device) into slots ``idx`` of ``pool``, in
    one launch, and return ``pool``; every other slot is untouched.

    The write is IN PLACE into the given leaves (the JAX version returns a
    new array that aliases its input buffer)."""
    rows = _rows(idx)
    single, leaves, layouts, dev = _layouts(pool, axis, len(rows))
    srcs = [blocks] if torch.is_tensor(blocks) else list(blocks)
    if len(srcs) != len(leaves):
        raise ValueError(f"{len(srcs)} blocks for {len(leaves)} leaves")
    for leaf, src, lay in zip(leaves, srcs, layouts):
        if src.shape != lay[3]:
            raise ValueError(f"blocks must be {lay[3]}, got "
                             f"{tuple(src.shape)}")
        if src.dtype != leaf.dtype or src.get_device() != dev:
            raise ValueError("blocks must match the leaf's dtype and device")
        if not src.is_contiguous():
            raise ValueError("blocks must be contiguous")
    _check_range(rows, layouts)
    if dev < 0:
        kv_block_scatter_ref(pool if single else leaves, rows,
                             blocks if single else srcs, axis=axis)
    elif _launch(False, leaves, srcs, layouts, rows, dev):
        kv_block_scatter.launches += 1
    return pool


kv_block_gather.launches = 0
kv_block_scatter.launches = 0
