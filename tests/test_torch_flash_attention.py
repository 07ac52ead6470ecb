"""The port's ``flash_attention_fwd`` against the JAX package's, on the CPU.

The same numpy inputs go to ``repro.kernels.ops.flash_attention`` (the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and
to the port's wrapper, which runs its plain version for CPU tensors.  The
shapes are the reference's sweep (``tests/test_kernels.py:19-48``).
Tolerances are the reference's: 2e-5 in fp32 (the two compute the same
fp32 softmax in different summation orders) and 2e-2 in bf16 (one bf16
rounding of the output, about 2^-8 relative, on either side).  bf16
inputs are rounded once from the same float32 draws on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa

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
