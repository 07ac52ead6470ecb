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
The packed buffer (rows, then scales, in one int8 buffer) is held to the
same tolerances, and must be written whole.
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
SENTINEL = 0x5A


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


def _packing(q, s):
    return torch.cat([q.reshape(-1), s.reshape(-1).view(torch.int8)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_packed_buffer_matches_pallas_kernel(shape, dtype):
    """``quantize_blocked(x, out=buf)``: the rows, then the scales, in one
    buffer, returned as its views; dequantized from those views.  The
    buffer holds the JAX package's numpy packing bit for bit.  Against the
    Pallas kernel the scales agree within 2 ulps (XLA's reciprocal, see
    the module docstring), and so do the int8 rows bit for bit in every
    row whose scale agrees exactly; where XLA moved a scale by an ulp, an
    element at a rounding tie may land one step away (here: one element
    of (37, 129) bf16)."""
    x = _inputs(shape, seed=2)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qj, sj, mj = jq.quantize_blocked(jnp.asarray(x).astype(dtype))
    rows = qj.shape[0]
    buf = torch.empty(tq.packed_bytes(xt.numel()), dtype=torch.int8)
    q, s, meta = tq.quantize_blocked(xt, out=buf)
    assert q.data_ptr() == buf.data_ptr()
    assert s.data_ptr() == buf.data_ptr() + rows * tq.BLOCK
    qn, sn, _ = jref.quantize_blocked_ref(xt.float().numpy())
    np.testing.assert_array_equal(buf.numpy(), np.concatenate(
        [qn.reshape(-1), sn.reshape(-1).view(np.int8)]))
    q_buf = buf[:rows * tq.BLOCK].view(rows, tq.BLOCK).numpy()
    s_buf = buf[rows * tq.BLOCK:].view(torch.float32).view(rows, 1).numpy()
    np.testing.assert_allclose(s_buf, np.asarray(sj), rtol=2.4e-7)
    same = (s_buf == np.asarray(sj))[:, 0]
    np.testing.assert_array_equal(q_buf[same], np.asarray(qj)[same])
    assert np.abs(q_buf.astype(int) - np.asarray(qj)).max() <= 1
    # the same rows and scales through the Pallas dequantize
    xr_j = np.asarray(jq.dequantize_blocked(jnp.asarray(q_buf),
                                            jnp.asarray(s_buf), mj))
    out = torch.empty_like(xt)
    assert tq.dequantize_blocked(q, s, meta, out=out) is out
    np.testing.assert_allclose(out.float().numpy(), xr_j.astype(np.float32),
                               rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_writes_every_byte_of_the_packed_buffer(shape):
    x = torch.from_numpy(_inputs(shape, seed=3))
    buf = torch.full((tq.packed_bytes(x.numel()),), SENTINEL,
                     dtype=torch.int8)
    tq.quantize_blocked(x, out=buf)
    want = _packing(*tq.quantize_blocked(x)[:2])
    assert not bool(((buf == SENTINEL) & (want != SENTINEL)).any())
    assert torch.equal(buf, want)


@pytest.mark.parametrize("numel,nbytes", [(0, 0), (1, 516), (512, 516),
                                          (513, 1032), (37 * 129, 10 * 516)])
def test_packed_bytes(numel, nbytes):
    assert tq.packed_bytes(numel) == nbytes


@pytest.mark.parametrize("bad", ["size", "dtype", "shape", "alignment",
                                 "device"])
def test_quantize_refuses_a_wrong_packed_buffer(bad):
    x = torch.from_numpy(_inputs((600,)))
    n = tq.packed_bytes(600)
    buf = {"size": lambda: torch.empty(n - 4, dtype=torch.int8),
           "dtype": lambda: torch.empty(n, dtype=torch.uint8),
           "shape": lambda: torch.empty((2, n // 2), dtype=torch.int8),
           "alignment": lambda: torch.empty(n + 1, dtype=torch.int8)[1:],
           "device": lambda: torch.empty(n, dtype=torch.int8,
                                         device="meta")}[bad]()
    with pytest.raises(ValueError):
        tq.quantize_blocked(x, out=buf)


def test_dequantize_refuses_an_out_off_host_and_card():
    """An ``out`` on neither the host nor a card is refused.  (A host
    operand of a card launch must be pinned: the C entry checks, so only
    the card can show that refusal, ``test_torch_cuda_kernels.py``.)"""
    q, s, meta = tq.quantize_blocked(torch.from_numpy(_inputs((600,))))
    with pytest.raises(ValueError):
        tq.dequantize_blocked(q, s, meta, out=torch.empty(600,
                                                          device="meta"))
