"""The port's blocked int8 quantize/dequantize (``kernels/offload_quant``)
against the JAX package's Pallas kernels, run in interpret mode as
``tests/test_kernels.py`` runs them, and its numpy versions
(``repro.kernels.ref``), on the same numpy inputs on the CPU.

On a CPU tensor the port's wrappers run their plain versions; the CUDA
kernels are held to those on the card (``test_torch_cuda_kernels.py``,
``chip_smoke.py``).  Tolerances: against the numpy versions, int8 rows
and scales bit-exact (the same IEEE fp32 division by 127 and by the scale,
and round-half-to-even); against the Pallas kernels, int8 rows bit-exact
and scales within 2 ulps (rtol 2.4e-7), because XLA's CPU compiler turns
the kernel's division by the constant 127 into a multiplication by its
reciprocal, which rounds differently in some rows (the reference's own
test compares only the int8 rows, ``tests/test_kernels.py:85-94``);
dequantized values rtol 1e-6, as the reference holds its numpy version;
round trips within absmax/127 per element, the reference's property.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import hypothesis_or_stub
from repro.kernels import offload_quant as jq
from repro.kernels import ref as jref
from repro_torch.kernels import offload_quant as tq
from repro_torch.kernels.ref import dequantize_blocked_ref

given, settings, st = hypothesis_or_stub()

SHAPES = [(1,), (511,), (512,), (513,), (37, 129), (3, 4, 100)]


def _inputs(shape, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_matches_pallas_kernel(shape, dtype):
    x = _inputs(shape)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qj, sj, (shape_j, dtype_j, pad_j) = jq.quantize_blocked(xj)
    q, s, (shape_t, dtype_t, pad_t) = tq.quantize_blocked(xt)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=2.4e-7)
    assert (shape_t, pad_t) == (tuple(shape_j), pad_j)
    assert str(dtype_t) == "torch." + dtype_j
    xr_j = np.asarray(jq.dequantize_blocked(qj, sj, (shape_j, dtype_j,
                                                     pad_j)))
    xr = tq.dequantize_blocked(q, s, (shape_t, dtype_t, pad_t))
    assert xr.dtype == xt.dtype and tuple(xr.shape) == shape
    np.testing.assert_allclose(xr.float().numpy(), xr_j.astype(np.float32),
                               rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_matches_numpy_reference(shape):
    x = _inputs(shape, seed=1)
    q2, s2, meta2 = jref.quantize_blocked_ref(x)
    q, s, meta = tq.quantize_blocked(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), q2)
    np.testing.assert_array_equal(s.numpy(), s2)
    np.testing.assert_allclose(
        tq.dequantize_blocked(q, s, meta).numpy(),
        jref.dequantize_blocked_ref(q2, s2, meta2), rtol=1e-6)


@settings(max_examples=20, deadline=None)
@given(rows=st.integers(1, 40), cols=st.integers(1, 700),
       scale=st.floats(1e-3, 1e3), seed=st.integers(0, 999))
def test_quant_roundtrip_property(rows, cols, scale, seed):
    x = torch.from_numpy(_inputs((rows, cols), seed, scale))
    xr = tq.dequantize_blocked(*tq.quantize_blocked(x))
    assert xr.shape == x.shape
    bound = float(x.abs().max()) / 127.0 + 1e-7
    assert float((xr - x).abs().max()) <= bound * 1.01


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x = torch.from_numpy(_inputs((4, 700)))
    n_q, n_d = tq.quantize_blocked.launches, tq.dequantize_blocked.launches
    q, s, meta = tq.quantize_blocked(x)
    out = torch.empty_like(x)
    assert tq.dequantize_blocked(q, s, meta, out=out) is out
    torch.testing.assert_close(out, dequantize_blocked_ref(q, s, meta),
                               rtol=0, atol=0)
    assert (tq.quantize_blocked.launches,
            tq.dequantize_blocked.launches) == (n_q, n_d)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.from_numpy(_inputs((600,)))
    q, s, meta = tq.quantize_blocked(x)
    with pytest.raises(TypeError):
        tq.quantize_blocked(x.double())
    with pytest.raises(ValueError):
        tq.quantize_blocked(torch.empty(8, device="meta"))
    with pytest.raises(ValueError):
        tq.dequantize_blocked(q, s, ((601,), torch.float32, meta[2]))
    with pytest.raises(ValueError):
        tq.dequantize_blocked(q.to(torch.int16), s, meta)
    with pytest.raises(ValueError):
        tq.dequantize_blocked(q, s, meta, out=torch.empty(5))
