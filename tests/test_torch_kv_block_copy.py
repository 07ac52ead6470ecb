"""The port's batched KV-block gather/scatter against the JAX package's
Pallas kernels (run in interpret mode on the CPU).

On a CPU tensor the port's wrappers run their plain versions; the check is
bit-exact (tolerance 0: a copy must not change a bit), for fp32 and bf16
and K in {1, 3, 7}, including the rows a scatter must leave alone and the
gather -> scatter round trip.  The kernel itself runs only on a CUDA
card: ``tests/test_torch_cuda_kernels.py`` holds it to the same standard
there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kv_block_copy import (kv_block_gather as jax_gather,
                                         kv_block_scatter as jax_scatter)
from repro_torch.kernels import kv_block_copy as kbc

N_ROWS, WIDTH = 16, 256
DTYPES = ("float32", "bfloat16")


def _np(dtype: str, shape, rng) -> np.ndarray:
    """Random values in ``dtype`` as numpy (bf16 via JAX's numpy dtype)."""
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


def _case(dtype: str, k: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    pool = _np(dtype, (N_ROWS, WIDTH), rng)
    idx = np.asarray(rng.permutation(N_ROWS)[:k], np.int32)
    blocks = _np(dtype, (k, WIDTH), rng)
    return pool, idx, blocks


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 3, 7])
def test_gather_matches_jax(dtype, k):
    pool, idx, _ = _case(dtype, k)
    want = np.asarray(jax_gather(pool, idx))
    launches = kbc.kv_block_gather.launches
    got = kbc.kv_block_gather(_torch(pool), torch.from_numpy(idx))
    np.testing.assert_array_equal(_back(got), want)
    assert got.dtype == _torch(pool).dtype and got.shape == (k, WIDTH)
    assert kbc.kv_block_gather.launches == launches   # CPU: no kernel


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 3, 7])
def test_scatter_matches_jax_and_leaves_other_rows(dtype, k):
    pool, idx, blocks = _case(dtype, k)
    want = np.asarray(jax_scatter(pool, idx, blocks))
    tpool = _torch(pool)
    launches = kbc.kv_block_scatter.launches
    got = kbc.kv_block_scatter(tpool, idx.tolist(), _torch(blocks))
    assert got is tpool                                # in place
    np.testing.assert_array_equal(_back(got), want)
    untouched = np.setdiff1d(np.arange(N_ROWS), idx)
    np.testing.assert_array_equal(_back(got)[untouched], pool[untouched])
    assert kbc.kv_block_scatter.launches == launches


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_scatter_round_trip_is_identity(dtype):
    pool, idx, _ = _case(dtype, 5)
    tpool = _torch(pool)
    rows = kbc.kv_block_gather(tpool, idx)
    back = kbc.kv_block_scatter(tpool.clone(), idx, rows)
    np.testing.assert_array_equal(_back(back), pool)
    jax_back = np.asarray(jax_scatter(pool, idx, jax_gather(pool, idx)))
    np.testing.assert_array_equal(_back(back), jax_back)


def test_wrappers_reject_what_the_kernel_cannot_take():
    pool = torch.zeros((4, 8))
    with pytest.raises(IndexError):
        kbc.kv_block_gather(pool, [4])
    with pytest.raises(IndexError):
        kbc.kv_block_gather(pool, [-1])
    with pytest.raises(ValueError, match="contiguous"):
        kbc.kv_block_gather(torch.zeros((8, 4)).t(), [0])
    with pytest.raises(ValueError, match="2-D"):
        kbc.kv_block_gather(torch.zeros(8), [0])
    with pytest.raises(ValueError):
        kbc.kv_block_scatter(pool, [0, 1], torch.zeros((1, 8)))
    with pytest.raises(ValueError):
        kbc.kv_block_scatter(pool, [0],
                             torch.zeros((1, 8), dtype=torch.bfloat16))
