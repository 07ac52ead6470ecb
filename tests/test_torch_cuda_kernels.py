"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marked ``cuda``; each test skips without one).  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: 0 for the KV row copies (a copy must not change a bit: they
are compared byte for byte, NaN payloads included); the
JAX reference's 2e-5 (fp32) and 2e-2 (bf16) for flash attention
(``tests/test_kernels.py:34``); its 1e-4 for the SSD intra-chunk kernel
(``tests/test_kernels.py:51-68``); 0 for the blocked int8 quantize and
dequantize (the same IEEE fp32 arithmetic and rounding as their plain
versions); the executor's copy stream against its inline swaps under
one plan at rtol 1e-3, atol 1e-5 (both compute the exact step; only the
order of the embedding backward's atomic adds differs).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.executor import fetch_packed
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kv_block_copy as kbc
from repro_torch.kernels import offload_quant as oq
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.ref import (dequantize_blocked_ref,
                                     flash_attention_ref, kv_block_gather_ref,
                                     kv_block_scatter_ref,
                                     quantize_blocked_ref,
                                     ssd_intra_chunk_ref)


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


# (shape, dtype, slot axis) of each leaf of one call: both models' full
# serving caches (4 slots), Mamba-2's fp32 state alone (75.5 MB rows), and
# leaves whose segments are not 16-byte multiples
LEAF_LAYOUTS = {
    "tinyllama": [((22, 4, 32, 4, 64), torch.bfloat16, 1)] * 2,
    "mamba2": [((48, 4, 3, 128), torch.bfloat16, 1),
               ((48, 4, 3, 128), torch.bfloat16, 1),
               ((48, 4, 3, 3072), torch.bfloat16, 1),
               ((48, 4, 48, 64, 128), torch.float32, 1)],
    "mamba2_state": [((48, 4, 48, 64, 128), torch.float32, 1)],
    "unaligned": [((3, 5, 7, 11), torch.bfloat16, 1),
                  ((2, 5, 33333), torch.bfloat16, 1),
                  ((6, 77), torch.uint8, 0),
                  ((4, 9, 13), torch.float32, 2)],
}


def _random_bits(shape, dtype, rng, offset: int = 0) -> torch.Tensor:
    """A contiguous card tensor of random bytes (NaN payloads included),
    its base ``offset`` elements past its allocation's."""
    item = torch.empty((), dtype=dtype).element_size()
    n = (int(np.prod(shape)) + offset) * item
    raw = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).cuda()
    return raw.view(dtype)[offset:].view(shape)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.uint8),
                                              b.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,k,offset", [
    ("tinyllama", 2, 0), ("tinyllama", 3, 0), ("mamba2", 2, 0),
    ("mamba2", 3, 0), ("mamba2_state", 2, 0), ("unaligned", 3, 0),
    ("unaligned", 3, 1),                 # bases off 16-byte alignment
])
def test_cuda_leaf_copies_match_plain_versions(layout, k, offset):
    """One gather and one scatter call move every leaf of the layout,
    read and written in place, bit-exact against the plain versions, with
    one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    spec = LEAF_LAYOUTS[layout]
    leaves = [_random_bits(s, dt, rng, offset) for s, dt, _ in spec]
    axes = [a for _, _, a in spec]
    idx = rng.permutation(min(s[a] for s, _, a in spec))[:k].tolist()
    g0, s0 = kbc.kv_block_gather.launches, kbc.kv_block_scatter.launches
    got = kbc.kv_block_gather(leaves, idx, axis=axes)
    want = kv_block_gather_ref(leaves, idx, axis=axes)
    blocks = [_random_bits(w.shape, w.dtype, rng) for w in want]
    mine = [leaf.clone() for leaf in leaves]
    ptrs = [m.data_ptr() for m in mine]
    assert kbc.kv_block_scatter(mine, idx, blocks, axis=axes) is mine
    plain = kv_block_scatter_ref([leaf.clone() for leaf in leaves], idx,
                                 blocks, axis=axes)
    torch.cuda.synchronize()
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    assert all(_same_bits(m, p) for m, p in zip(mine, plain))
    assert [m.data_ptr() for m in mine] == ptrs
    assert (kbc.kv_block_gather.launches, kbc.kv_block_scatter.launches) \
        == (g0 + 1, s0 + 1)


@pytest.mark.cuda
def test_one_wrapper_call_is_one_kernel_and_no_upload():
    """A profile of one gather call, and of one scatter call, over both of
    TinyLlama's cache leaves shows one kernel and no host-to-device copy:
    the indices travel in the kernel's parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(0)
    leaves = [_random_bits(s, dt, rng)
              for s, dt, _ in LEAF_LAYOUTS["tinyllama"]]
    rows = kbc.kv_block_gather(leaves, [0, 2], axis=1)      # build, warm up
    torch.cuda.synchronize()
    for call in (lambda: kbc.kv_block_gather(leaves, [0, 2], axis=1),
                 lambda: kbc.kv_block_scatter(leaves, [0, 2], rows, axis=1)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 1 and "copy_" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal,dtype,window", [
    (2, 512, 512, 32, 4, 64, True, torch.bfloat16, 0),   # TinyLlama's heads
    (1, 200, 200, 6, 2, 112, True, torch.float32, 0),    # ragged, D padded
    (2, 64, 256, 4, 4, 256, False, torch.float32, 0),    # D 256, cross shape
    # the tensor-core path at every padded head dim
    (1, 200, 200, 8, 1, 32, True, torch.bfloat16, 0),    # MQA, ragged
    (2, 64, 256, 4, 4, 128, False, torch.bfloat16, 0),   # cross shape
    (1, 384, 384, 6, 2, 112, True, torch.bfloat16, 0),   # D padded to 128
    (1, 96, 96, 2, 2, 256, True, torch.bfloat16, 0),
    (1, 256, 256, 4, 2, 64, True, torch.bfloat16, 64),   # rows wiped
    (1, 77, 77, 4, 2, 100, True, torch.bfloat16, 0),     # D padded to 104
])
def test_flash_kernel_matches_plain_version(b, sq, skv, h, kvh, d, causal,
                                            dtype, window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(dtype).cuda()
               for s in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d)))
    n0 = fa.flash_attention_fwd.launches
    with torch.inference_mode():
        got = fa.flash_attention_fwd(q, k, v, causal=causal,
                                     sliding_window=window)
        again = fa.flash_attention_fwd(q, k, v, causal=causal,
                                       sliding_window=window)
        want = flash_attention_ref(q, k, v, causal=causal,
                                   sliding_window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == n0 + 2
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype and got.shape == (b, sq, h, d)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, again)          # no atomics, a fixed kv order


@pytest.mark.cuda
def test_flash_bf16_reads_views_and_copies_misaligned_inputs():
    """q, k and v as views of one fused projection, q as a transposed
    (B,H,S,D) tensor, and a q whose base is not 16-byte aligned (which the
    wrapper copies rather than refuse) all give the plain version's
    result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(1)
    b, s, h, kvh, d = 2, 150, 8, 2, 64
    qkv = torch.from_numpy(rng.standard_normal(
        (b, s, h + 2 * kvh, d), dtype=np.float32)).bfloat16().cuda()
    q, k, v = qkv.split([h, kvh, kvh], dim=2)
    flat = torch.from_numpy(rng.standard_normal(
        b * s * h * d + 1, dtype=np.float32)).bfloat16().cuda()
    q_odd = flat[1:].view(b, s, h, d)        # base 2 bytes past alignment
    q_bhsd = flat[:-1].view(b, h, s, d).transpose(1, 2)
    with torch.inference_mode():
        for qq in (q, q_odd, q_bhsd):
            got = fa.flash_attention_fwd(qq, k, v, causal=True)
            want = flash_attention_ref(qq, k, v, causal=True)
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                       atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,q,h,p,n,dtype", [
    (2, 3, 64, 4, 16, 32, torch.float32),      # the reference's sweep
    (1, 2, 128, 2, 64, 128, torch.float32),
    (1, 5, 32, 8, 64, 16, torch.float32),
    (1, 1, 200, 4, 64, 128, torch.float32),    # ragged chunk
    (1, 2, 255, 6, 64, 128, torch.float32),    # Q 255
    (1, 1, 130, 2, 20, 18, torch.float32),     # P 20, N 18
    # the tensor-core kernel (bf16 x)
    (2, 3, 64, 4, 16, 32, torch.bfloat16),
    (1, 1, 200, 4, 64, 128, torch.bfloat16),
    (1, 2, 256, 48, 64, 128, torch.bfloat16),  # Mamba-2 780M's heads
    (1, 1, 1, 4, 64, 128, torch.bfloat16),     # Q 1
    (1, 2, 255, 6, 64, 128, torch.bfloat16),   # Q 255
    (1, 2, 96, 3, 40, 64, torch.bfloat16),     # P 40, padded to 64
    (1, 1, 130, 2, 20, 18, torch.bfloat16),    # P 20, N 18: plain loads
    (1, 1, 192, 2, 128, 200, torch.bfloat16),  # P 128, N over one pass
    (1, 1, 128, 13, 24, 32, torch.bfloat16),   # P 24; 13 heads: 7 and 6
])
def test_ssd_kernel_matches_plain_version(b, nc, q, h, p, n, dtype):
    """Within the reference's 1e-4; a second call gives the same bits (no
    atomics, a fixed order of sums), and a profile of one call holds one
    device kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(0)

    def softplus(a):
        return np.log1p(np.exp(a)).astype(np.float32)

    x = rng.standard_normal((b, nc, q, h, p), dtype=np.float32)
    dt = softplus(rng.standard_normal((b, nc, q, h), dtype=np.float32))
    da = -softplus(rng.standard_normal((b, nc, q, h), dtype=np.float32))
    bc = rng.standard_normal((b, nc, q, n), dtype=np.float32)
    cc = rng.standard_normal((b, nc, q, n), dtype=np.float32)
    args = [torch.from_numpy(a).cuda() for a in (x, dt, da, bc, cc)]
    args[0] = args[0].to(dtype)
    n0 = ssd_scan.ssd_intra_chunk_fwd.launches
    with torch.inference_mode():
        y, st = ssd_scan.ssd_intra_chunk_fwd(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            y2, st2 = ssd_scan.ssd_intra_chunk_fwd(*args)
            torch.cuda.synchronize()
        y_ref, st_ref = ssd_intra_chunk_ref(*args)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_intra_chunk_fwd.launches == n0 + 2
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "ssd_fwd" in names[0], names   # either kernel
    assert y.dtype == st.dtype == torch.float32
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("shape", [(1,), (511,), (513,), (37, 129),
                                   (4, 1024, 5632)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_quant_kernels_match_plain_versions(shape, dtype, misaligned):
    """Every route of a swap: card to card, card to a packed pinned buffer
    (pre-filled with a sentinel, then holding the plain packing byte for
    byte), and that buffer to the card, read by the kernel or first copied
    whole (the executor's ``fetch_packed``); each call one launch.  With
    ``misaligned`` the input and the outputs are views one element into
    their storage (the kernels' scalar path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    n = int(np.prod(shape))
    flat = torch.from_numpy(rng.standard_normal(n + 1, dtype=np.float32)
                            * 3).to(dtype).cuda()
    off = int(misaligned)
    x = flat[off:off + n].view(shape)

    def out():
        return torch.empty(n + 1, dtype=dtype,
                           device="cuda")[off:off + n].view(shape)

    nq, nd = oq.quantize_blocked.launches, oq.dequantize_blocked.launches
    q, s, meta = oq.quantize_blocked(x)
    qr, sr, mr = quantize_blocked_ref(x)
    want = dequantize_blocked_ref(qr, sr, mr)
    dst = out()
    xk = oq.dequantize_blocked(q, s, meta, out=dst)
    x_new = oq.dequantize_blocked(q, s, meta)
    buf = torch.full((oq.packed_bytes(n),), 0x5A, dtype=torch.int8,
                     pin_memory=True)
    qh, sh, mh = oq.quantize_blocked(x, out=buf)
    xh = oq.dequantize_blocked(qh, sh, mh, out=out())
    xc = fetch_packed(qh, sh, mh, out(), copy=True)
    torch.cuda.synchronize()
    assert torch.equal(q, qr) and torch.equal(s, sr) and meta == mr == mh
    assert xk is dst and torch.equal(xk, want) and torch.equal(xh, want)
    assert torch.equal(x_new, want) and torch.equal(xc, want)
    assert qh.data_ptr() == buf.data_ptr()
    assert torch.equal(buf, torch.cat([qr.reshape(-1).cpu(), sr.reshape(
        -1).cpu().view(torch.int8)]))
    assert (oq.quantize_blocked.launches,
            oq.dequantize_blocked.launches) == (nq + 2, nd + 4)


@pytest.mark.cuda
def test_quant_wrappers_refuse_unpinned_host_operands():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(1000, device="cuda")
    q, s, meta = oq.quantize_blocked(x)
    with pytest.raises(ValueError, match="pinned"):
        oq.quantize_blocked(x, out=torch.empty(oq.packed_bytes(1000),
                                               dtype=torch.int8))
    with pytest.raises(ValueError, match="pinned"):
        oq.dequantize_blocked(q.cpu(), s.cpu(), meta,
                              out=torch.empty_like(x))


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
