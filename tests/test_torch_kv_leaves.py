"""The leaf and multi-leaf forms of the port's KV gather/scatter against the
JAX package's Pallas kernels (interpret mode on the CPU).

The JAX engine turns a cache leaf into a row pool with
``moveaxis(leaf, a, 0).reshape(N, -1)`` and runs the Pallas kernels on it;
the port's wrappers take the leaf itself and its slot axis.  On the same
numpy leaf both must give the same bits (tolerance 0), for slot axes 0 and
1, fp32 and bf16 and K in {1, 2, 3}, at the cache layouts of TinyLlama (L,
B, T, KV, Dh) and Mamba-2 (L, B, H, P, N) at small sizes.  A multi-leaf
call (mixed dtypes and widths) must equal one JAX call per leaf, write in
place, and leave every other slot alone.  On the CPU the wrappers run their
plain versions and launch nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kv_block_copy import (kv_block_gather as jax_gather,
                                         kv_block_scatter as jax_scatter)
from repro_torch.kernels import kv_block_copy as kbc

LAYOUTS = {"tinyllama": (3, 4, 6, 2, 8),     # (L, B, T, KV, Dh)
           "mamba2": (4, 3, 2, 4, 8)}        # (L, B, H, P, N)
DTYPES = ("float32", "bfloat16")


def _np(dtype: str, shape, rng) -> np.ndarray:
    x = rng.standard_normal(shape).astype(np.float32)
    return x if dtype == "float32" else x.astype(jnp.bfloat16)


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _back(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def jax_leaf_gather(leaf: np.ndarray, idx, axis: int) -> np.ndarray:
    """What the JAX engine does: a row pool of the moved leaf, the Pallas
    gather, the row shape restored."""
    moved = np.moveaxis(leaf, axis, 0)
    pool = jnp.asarray(moved.reshape(moved.shape[0], -1))
    rows = jax_gather(pool, np.asarray(idx, np.int32))
    return np.asarray(rows).reshape((len(idx),) + moved.shape[1:])


def jax_leaf_scatter(leaf: np.ndarray, idx, blocks: np.ndarray,
                     axis: int) -> np.ndarray:
    moved = np.moveaxis(leaf, axis, 0)
    pool = jnp.asarray(moved.reshape(moved.shape[0], -1))
    out = jax_scatter(pool, np.asarray(idx, np.int32),
                      jnp.asarray(blocks.reshape(len(idx), -1)))
    return np.moveaxis(np.asarray(out).reshape(moved.shape), 0, axis)


def _case(layout: str, dtype: str, axis: int, k: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    shape = LAYOUTS[layout]
    leaf = _np(dtype, shape, rng)
    idx = rng.permutation(shape[axis])[:k].tolist()
    rest = shape[:axis] + shape[axis + 1:]
    blocks = _np(dtype, (k,) + rest, rng)
    return leaf, idx, blocks


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_leaf_gather_matches_jax(layout, axis, dtype, k):
    leaf, idx, _ = _case(layout, dtype, axis, k)
    want = jax_leaf_gather(leaf, idx, axis)
    launches = kbc.kv_block_gather.launches
    got = kbc.kv_block_gather(_torch(leaf), idx, axis=axis)
    assert got.is_contiguous() and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bits(_back(got)), _bits(want))
    assert kbc.kv_block_gather.launches == launches      # CPU: no kernel


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_leaf_scatter_matches_jax_in_place(layout, axis, dtype, k):
    leaf, idx, blocks = _case(layout, dtype, axis, k)
    want = jax_leaf_scatter(leaf, idx, blocks, axis)
    tleaf = _torch(leaf)
    ptr = tleaf.data_ptr()
    launches = kbc.kv_block_scatter.launches
    got = kbc.kv_block_scatter(tleaf, idx, _torch(blocks), axis=axis)
    assert got is tleaf and tleaf.data_ptr() == ptr     # in place
    np.testing.assert_array_equal(_bits(_back(tleaf)), _bits(want))
    others = np.setdiff1d(np.arange(leaf.shape[axis]), idx)
    np.testing.assert_array_equal(
        _bits(np.take(_back(tleaf), others, axis=axis)),
        _bits(np.take(leaf, others, axis=axis)))
    assert kbc.kv_block_scatter.launches == launches


def _mixed_leaves(rng):
    """A cache's slotted leaves of mixed dtype and width: (leaf, axis)."""
    return [(_np("bfloat16", (3, 4, 6, 2, 8), rng), 1),
            (_np("float32", (3, 4, 2, 4, 8), rng), 1),
            (_np("bfloat16", (4, 5, 3), rng), 0),
            (_np("float32", (2, 7, 4), rng), 2)]


def test_multi_leaf_gather_matches_per_leaf_jax_calls():
    rng = np.random.default_rng(5)
    leaves = _mixed_leaves(rng)
    idx = [3, 0, 2]
    got = kbc.kv_block_gather([_torch(x) for x, _ in leaves], idx,
                              axis=[a for _, a in leaves])
    assert isinstance(got, list) and len(got) == len(leaves)
    for g, (leaf, a) in zip(got, leaves):
        want = jax_leaf_gather(leaf, idx, a)
        assert g.dtype == _torch(leaf).dtype
        np.testing.assert_array_equal(_bits(_back(g)), _bits(want))


def test_multi_leaf_scatter_matches_per_leaf_jax_calls_in_place():
    rng = np.random.default_rng(6)
    leaves = _mixed_leaves(rng)
    idx = [1, 3]
    axes = [a for _, a in leaves]
    tleaves = [_torch(x) for x, _ in leaves]
    ptrs = [t.data_ptr() for t in tleaves]
    blocks = [_np(str(x.dtype), (len(idx),) + tuple(np.delete(x.shape, a)),
                  rng) for x, a in leaves]
    out = kbc.kv_block_scatter(tleaves, idx, [_torch(b) for b in blocks],
                               axis=axes)
    assert out is tleaves and [t.data_ptr() for t in tleaves] == ptrs
    for t, (leaf, a), b in zip(tleaves, leaves, blocks):
        want = jax_leaf_scatter(leaf, idx, b, a)
        np.testing.assert_array_equal(_bits(_back(t)), _bits(want))


def test_gather_scatter_round_trip_of_every_leaf_is_identity():
    rng = np.random.default_rng(7)
    leaves = _mixed_leaves(rng)
    axes = [a for _, a in leaves]
    tleaves = [_torch(x) for x, _ in leaves]
    rows = kbc.kv_block_gather(tleaves, [2, 0], axis=axes)
    kbc.kv_block_scatter(tleaves, [2, 0], rows, axis=axes)
    for t, (leaf, _) in zip(tleaves, leaves):
        np.testing.assert_array_equal(_bits(_back(t)), _bits(leaf))


def test_leaf_forms_reject_what_the_kernel_cannot_take():
    leaf = torch.zeros((2, 4, 3))
    with pytest.raises(ValueError, match="MAX_ROWS = 512"):
        kbc.kv_block_gather(leaf, [0] * (kbc.MAX_ROWS + 1), axis=1)
    with pytest.raises(ValueError, match="MAX_LEAVES = 16"):
        kbc.kv_block_gather([leaf] * (kbc.MAX_LEAVES + 1), [0], axis=1)
    with pytest.raises(IndexError):
        kbc.kv_block_gather(leaf, [4], axis=1)
    with pytest.raises(IndexError):
        kbc.kv_block_gather(leaf, [-1], axis=1)
    with pytest.raises(IndexError):        # in range of one leaf, not both
        kbc.kv_block_gather([leaf, torch.zeros((2, 3))], [3], axis=[1, 1])
    with pytest.raises(ValueError, match="out of range"):
        kbc.kv_block_gather(leaf, [0], axis=3)
    with pytest.raises(ValueError, match="contiguous"):
        kbc.kv_block_gather(leaf.transpose(0, 2), [0], axis=1)
    with pytest.raises(ValueError, match="axes"):
        kbc.kv_block_gather([leaf, leaf], [0], axis=[1])
    with pytest.raises(ValueError):        # blocks of the wrong shape
        kbc.kv_block_scatter(leaf, [0, 1], torch.zeros((1, 2, 3)), axis=1)
    with pytest.raises(ValueError):        # one block for two leaves
        kbc.kv_block_scatter([leaf, leaf], [0], [torch.zeros((1, 2, 3))],
                             axis=1)
    # the cap is the kernel's parameter block; it holds exactly MAX_ROWS
    assert kbc.kv_block_gather(leaf, [1] * kbc.MAX_ROWS,
                               axis=1).shape == (kbc.MAX_ROWS, 2, 3)
