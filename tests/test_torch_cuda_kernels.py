"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marked ``cuda``; each test skips without one).  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: 0 for the KV row copies (a copy must not change a bit); the
JAX reference's 2e-5 (fp32) and 2e-2 (bf16) for flash attention
(``tests/test_kernels.py:34``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_block_copy as kbc
from repro_torch.kernels.ref import (flash_attention_ref, kv_block_gather_ref,
                                     kv_block_scatter_ref)


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal,dtype", [
    (2, 512, 512, 32, 4, 64, True, torch.bfloat16),    # TinyLlama's heads
    (1, 200, 200, 6, 2, 112, True, torch.float32),     # ragged, D padded
    (2, 64, 256, 4, 4, 256, False, torch.float32),     # D 256, cross shape
])
def test_flash_kernel_matches_plain_version(b, sq, skv, h, kvh, d, causal,
                                            dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(dtype).cuda()
               for s in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d)))
    n0 = fa.flash_attention_fwd.launches
    with torch.inference_mode():
        got = fa.flash_attention_fwd(q, k, v, causal=causal)
        want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == n0 + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
