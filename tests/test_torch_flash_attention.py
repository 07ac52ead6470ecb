"""The port's ``flash_attention_fwd`` against the JAX package's, on the CPU.

The same numpy inputs go to ``repro.kernels.ops.flash_attention`` (the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and
to the port's wrapper, which runs its plain version for CPU tensors.  The
shapes are the reference's sweep (``tests/test_kernels.py:19-48``).
Tolerances are the reference's: 2e-5 in fp32 (the two compute the same
fp32 softmax in different summation orders) and 2e-2 in bf16 (one bf16
rounding of the output, about 2^-8 relative, on either side).  bf16
inputs are rounded once from the same float32 draws on both sides.

The card's bf16 kernel rounds P to bf16 before the P.V product, which the
plain version does not; ``_mma_model`` repeats that arithmetic in plain
torch, and the bf16 sweep holds it to the Pallas kernel within 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.build import ptxas_usage

SWEEP = [
    (2, 128, 128, 4, 2, 64, True, "float32"),
    (1, 200, 200, 8, 1, 32, True, "float32"),      # MQA, ragged seq
    (2, 64, 256, 4, 4, 128, False, "float32"),     # cross-shaped
    (1, 384, 384, 6, 2, 112, True, "float32"),     # kimi head_dim
    (2, 256, 256, 4, 2, 64, True, "bfloat16"),
    (1, 96, 96, 2, 2, 256, True, "float32"),       # gemma head_dim
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(b, sq, skv, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, kvh, d), dtype=np.float32),
            rng.standard_normal((b, skv, kvh, d), dtype=np.float32))


def _both(arrays, dtype):
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    pt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, pt


@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal,dtype", SWEEP)
def test_flash_matches_reference_sweep(b, sq, skv, h, kvh, d, causal, dtype):
    (jq, jk, jv), (q, k, v) = _both(_inputs(b, sq, skv, h, kvh, d), dtype)
    want = np.asarray(jax_flash(jq, jk, jv, causal=causal), np.float32)
    n0 = fa.flash_attention_fwd.launches
    got = fa.flash_attention_fwd(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == (b, sq, h, d)
    assert fa.flash_attention_fwd.launches == n0     # no kernel on the CPU
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("window", [64, 200])
def test_flash_matches_reference_sliding_window(window):
    (jq, jk, jv), (q, k, v) = _both(_inputs(1, 256, 256, 4, 2, 64),
                                    "float32")
    want = jax_flash(jq, jk, jv, causal=True, sliding_window=window)
    got = fa.flash_attention_fwd(q, k, v, causal=True, sliding_window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _qkv(h=4, kvh=2, d=32, dtype=torch.float32):
    (_, _, _), (q, k, v) = _both(_inputs(1, 8, 8, h, kvh, d), "float32")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def test_flash_refuses_heads_not_a_multiple_of_kv_heads():
    q, k, v = _qkv(h=6, kvh=4)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_fwd(q, k, v)


def test_flash_refuses_head_dim_above_256():
    q, k, v = _qkv(d=320)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, k, v)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_flash_refuses_other_dtypes(dtype):
    q, k, v = _qkv(dtype=dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(q, k, v)


def test_flash_refuses_mixed_dtypes():
    q, k, v = _qkv()
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention_fwd(q, k.bfloat16(), v)


def test_flash_refuses_other_devices():
    q, k, v = (t.to("meta") for t in _qkv())
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_fwd(q, k, v)


def test_flash_is_forward_only():
    """The reference's ``jax.grad`` through the Pallas call fails; the port
    refuses autograd instead of differentiating its plain version."""
    q, k, v = _qkv()
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_attention_fwd(q, k, v)
    with torch.no_grad():
        out = fa.flash_attention_fwd(q, k, v)
    assert not out.requires_grad


# The bf16 tensor-core kernel's tiles, (q rows, kv columns) per block by
# padded head dim, as ``csrc/flash_attention.cu::dispatch_tma`` picks them
# (64 q rows per consumer warpgroup; kBlockK kv rows).
MMA_TILES = {64: (192, 64), 128: (128, 64), 256: (64, 64)}
NEG_INF = -1e30
LOG2E = np.float32(1.4426950408889634)


def _mma_model(q, k, v, *, causal, window=0, stats=None):
    """The tensor-core kernel's arithmetic on bf16 inputs, in plain torch:
    per block of q rows, the kv tiles it visits in order (causal tiles past
    the block and window tiles before it skipped, as the kernel skips
    them); fp32 scores of the bf16 operands, scaled by scale*log2(e) after
    the product; the -1e30 fill; an online max and sum with exp2; the
    unnormalised P rounded to bf16 per kv tile for P.V, the row sum taken
    from the fp32 P; the fp32 O rescaled once per tile; one division at
    the end.  (On tiles without a mask edge the kernel fuses the scale into
    the FMA of the exponent's argument, one fp32 rounding fewer than here.)
    ``stats['wiped']`` counts rows whose first visited tile was wholly
    masked (m still -1e30 after it)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dp = next(x for x in (64, 128, 256) if d <= x)
    bq, bk = MMA_TILES[dp]
    scale = np.float32(1.0 / np.sqrt(d))
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    pad = -skv % bk
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    kf = kf.repeat_interleave(h // kvh, dim=2).transpose(1, 2)  # B,H,S,D
    vf = vf.repeat_interleave(h // kvh, dim=2).transpose(1, 2)
    qf = q.float().transpose(1, 2)
    out = torch.zeros((b, h, sq, d), dtype=torch.float32)
    wiped = 0
    for q0 in range(0, sq, bq):
        rows = slice(q0, min(q0 + bq, sq))
        qpos = torch.arange(q0, rows.stop)[:, None]
        k_end = min(skv, q0 + bq) if causal else skv
        k_begin = 0
        if window and q0 - window + 1 > 0:
            k_begin = (q0 - window + 1) // bk * bk
        n = rows.stop - q0
        m = torch.full((b, h, n), NEG_INF)
        l = torch.zeros((b, h, n))
        acc = torch.zeros((b, h, n, d))
        for k0 in range(k_begin, k_end, bk):
            kpos = torch.arange(k0, k0 + bk)[None, :]
            s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, rows],
                             kf[:, :, k0:k0 + bk]) * scale_log2
            mask = kpos < skv
            if causal:
                mask = mask & (kpos <= qpos)
            if window:
                mask = mask & (kpos > qpos - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            if k0 == k_begin:
                wiped += int((m_new == NEG_INF).sum())
            p = torch.exp2(s - m_new[..., None])
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.bfloat16().float(),
                vf[:, :, k0:k0 + bk])
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l[..., None], min=1e-30)
    if stats is not None:
        stats["wiped"] = wiped
    return out.transpose(1, 2).to(q.dtype)


# the bf16 twins of the reference's fp32 sweep shapes, and the sliding
# windows; (B, Sq, Skv, H, KV, D, causal, window)
BF16_SWEEP = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 200, 200, 8, 1, 32, True, 0),       # MQA, ragged seq
    (2, 64, 256, 4, 4, 128, False, 0),      # cross-shaped
    (1, 384, 384, 6, 2, 112, True, 0),      # D padded to 128
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 96, 96, 2, 2, 256, True, 0),        # BQ 64
    (1, 256, 256, 4, 2, 64, True, 64),      # rows wiped
    (1, 256, 256, 4, 2, 64, True, 200),
]


@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal,window", BF16_SWEEP)
def test_tensor_core_rounding_matches_reference(b, sq, skv, h, kvh, d, causal,
                                                window):
    """bf16 P in the P.V product (what the tensor-core kernel feeds its
    second mma) stays within the reference's bf16 tolerance of the Pallas
    kernel in interpret mode."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(b, sq, skv, h, kvh, d),
                                    "bfloat16")
    want = np.asarray(jax_flash(jq, jk, jv, causal=causal,
                                sliding_window=window), np.float32)
    got = _mma_model(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_tensor_core_model_wipes_rows_whose_first_tile_is_masked():
    """With a window of 64, the block of q rows 192..255 starts at kv tile
    128..191, wholly masked for row 255: its first m is -1e30 and P is 1
    there; in the block of rows 0..191, which starts at tile 0..63, so are
    rows 127..191.  The next tile's exp(m_prev - m_new) = 0 must wipe that,
    as it does in the reference; a -inf fill would give NaN."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(1, 256, 256, 4, 2, 64),
                                    "bfloat16")
    stats = {}
    got = _mma_model(q, k, v, causal=True, window=64, stats=stats)
    assert stats["wiped"] == 4 * (65 + 1)   # rows 127..191, 255; 4 heads
    assert bool(torch.isfinite(got.float()).all())
    want = np.asarray(jax_flash(jq, jk, jv, causal=True, sliding_window=64),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113flash_fwd_mmaILi64ELi128ELi64ELb1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113flash_fwd_mmaILi64ELi128ELi64ELb1EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 544 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19flash_fwdILi256ELi32EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19flash_fwdILi256ELi32EEEvNS_6ParamsE
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 544 bytes cmem[0]
"""


def test_ptxas_usage_reads_registers_and_spills_per_kernel():
    use = ptxas_usage(PTXAS_LOG)
    assert use == {
        "_ZN12_GLOBAL__N_113flash_fwd_mmaILi64ELi128ELi64ELb1EEEvNS_6ParamsE":
            {"stack": 0, "spill_stores": 0, "spill_loads": 0,
             "registers": 96},
        "_ZN12_GLOBAL__N_19flash_fwdILi256ELi32EEEvNS_6ParamsE":
            {"stack": 8, "spill_stores": 12, "spill_loads": 16,
             "registers": 255}}
