"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marked ``cuda``; each test skips without one).  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerance 0: a row copy must not change a bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import kv_block_copy as kbc
from repro_torch.kernels.ref import kv_block_gather_ref, kv_block_scatter_ref


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,dtype,k", [
    (4, 22 * 32 * 4 * 64, torch.bfloat16, 2),   # the serving pool, 16-B path
    (4, 22 * 32 * 4 * 64, torch.float32, 3),
    (7, 1001, torch.bfloat16, 3),               # 2-byte element path
    (6, 77, torch.uint8, 4),                    # 1-byte element path
])
def test_cuda_kernel_matches_plain_version(n, w, dtype, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    pool = torch.from_numpy(rng.standard_normal((n, w)) * 50).to(dtype).cuda()
    blocks = torch.from_numpy(rng.standard_normal((k, w)) * 50).to(
        dtype).cuda()
    idx = rng.permutation(n)[:k].tolist()
    g0, s0 = kbc.kv_block_gather.launches, kbc.kv_block_scatter.launches
    assert torch.equal(kbc.kv_block_gather(pool, idx),
                       kv_block_gather_ref(pool, idx))
    got = kbc.kv_block_scatter(pool.clone(), idx, blocks)
    want = kv_block_scatter_ref(pool.clone(), idx, blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (kbc.kv_block_gather.launches, kbc.kv_block_scatter.launches) \
        == (g0 + 1, s0 + 1)
