"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marked ``cuda``; each test skips without one).  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: 0 for the KV row copies (a copy must not change a bit); the
JAX reference's 2e-5 (fp32) and 2e-2 (bf16) for flash attention
(``tests/test_kernels.py:34``); 0 for the blocked int8 quantize and
dequantize (the same IEEE fp32 arithmetic and rounding as their plain
versions); the executor's copy stream against its inline swaps under
one plan at rtol 1e-3, atol 1e-5 (both compute the exact step; only the
order of the embedding backward's atomic adds differs).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_block_copy as kbc
from repro_torch.kernels import offload_quant as oq
from repro_torch.kernels.ref import (dequantize_blocked_ref,
                                     flash_attention_ref, kv_block_gather_ref,
                                     kv_block_scatter_ref,
                                     quantize_blocked_ref)


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1,), (511,), (513,), (37, 129),
                                   (4, 1024, 5632)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_quant_kernels_match_plain_versions(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                         * 3).to(dtype).cuda()
    nq, nd = oq.quantize_blocked.launches, oq.dequantize_blocked.launches
    q, s, meta = oq.quantize_blocked(x)
    qr, sr, mr = quantize_blocked_ref(x)
    xk = oq.dequantize_blocked(q, s, meta)
    torch.cuda.synchronize()
    assert torch.equal(q, qr) and torch.equal(s, sr) and meta == mr
    assert torch.equal(xk, dequantize_blocked_ref(q, s, meta))
    assert (oq.quantize_blocked.launches,
            oq.dequantize_blocked.launches) == (nq + 1, nd + 1)
    out = torch.empty_like(x)
    assert oq.dequantize_blocked(q, s, meta, out=out) is out
    torch.cuda.synchronize()
    assert torch.equal(out, xk)


@pytest.mark.cuda
def test_async_swaps_match_inline_swaps():
    """The reduced TinyLlama train step under a plan with compressed swaps,
    releases and prefetches of the same tensors: with the events
    uncompressed, the executor on its copy stream (fenced by events)
    computes what it computes with every swap inline; compressed, it
    launches both kernels and stays finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    import repro_torch.core as tc
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import build_functional_train_step
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim.adam import adamw_init

    cfg = get_config("tinyllama-1.1b").reduced(remat="none", n_layers=2)
    api = get_model(cfg, "cuda")
    params = dict(TransformerLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0)).named_parameters())
    batch = api.input_specs(ShapeSpec("s", 64, 2, "train"), abstract=False)
    args = (params, adamw_init(params), batch)
    seq, gm = tc.capture_train_step(build_functional_train_step(api), *args)
    prof = tc.MachineProfile()
    unsched = tc.simulate([seq], None, prof, iterations=1).peak_bytes
    cfg_s = tc.SchedulerConfig(memory_budget_bytes=int(0.6 * unsched),
                               patience_iters=10 ** 4)
    ms = tc.MemoryScheduler(prof, cfg_s, pipeline=tc.Pipeline(
        [tc.CompressedOffloadPass(), tc.SwapPass(), tc.RecomputePass()],
        profile=prof, config=cfg_s))
    ms.register_job(seq)
    plan = ms.schedule().plans[seq.job_id]
    assert any(e.compressed for e in plan.events)
    exact = tc.SchedulingPlan(seq.job_id)
    for e in plan.events:
        exact.add(dataclasses.replace(e, compressed=False))
    inline = tc.FxExecutor(gm, seq, exact).run(*args)
    out = tc.FxExecutor(gm, seq, exact, async_swap=True).run(*args)
    for a, b in zip(out, inline):
        torch.testing.assert_close(a.cpu(), b.cpu(), rtol=1e-3, atol=1e-5)
    q0, d0 = oq.quantize_blocked.launches, oq.dequantize_blocked.launches
    ex = tc.FxExecutor(gm, seq, plan, async_swap=True)
    comp = ex.run(*args)
    assert ex.stats.compressed_swaps > 0
    assert oq.quantize_blocked.launches > q0
    assert oq.dequantize_blocked.launches > d0
    assert all(bool(torch.isfinite(o).all()) for o in comp
               if o.is_floating_point())
