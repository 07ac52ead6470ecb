"""The port's int8 error-feedback gradient compression (``optim.
compression``) and the optimizer state that carries its residual, against
the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both packages.  Tolerance: none;
the block quantization is the same IEEE fp32 arithmetic (max, divide,
round half to even, clip, multiply, subtract) on the same values, so the
gradients and residuals compare bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adam as jax_adam
from repro.optim import compression as ref
from repro_torch.configs import get_config
from repro_torch.convert import adam_state_from_jax, params_from_jax
from repro_torch.optim import adam, compression


def _values(n: int, seed: int = 0) -> np.ndarray:
    """``n`` normal values at mixed scales, with an all-zero block where
    there is room for one."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * np.float32(
        10.0) ** rng.integers(-3, 3, n).astype(np.float32)
    if n >= 2 * ref.BLOCK:
        x[ref.BLOCK:2 * ref.BLOCK] = 0.0
    return x


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 10_000])
def test_quantize_dequantize_matches_reference(n):
    x = _values(n, seed=n)
    want = np.asarray(ref.quantize_dequantize(jnp.asarray(x)))
    got = compression.quantize_dequantize(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # one value is its block's maximum, which int8 holds exactly
    assert np.array_equal(got, x) == (n == 1)


def test_an_all_zero_tensor_stays_zero():
    z = np.zeros(3000, np.float32)
    got = compression.quantize_dequantize(torch.from_numpy(z)).numpy()
    assert np.array_equal(got, np.asarray(
        ref.quantize_dequantize(jnp.asarray(z)))) and not got.any()


def test_bf16_gradients_round_trip_as_the_reference():
    x = _values(5000, seed=3)
    want = ref.quantize_dequantize(jnp.asarray(x, dtype=jnp.bfloat16))
    got = compression.quantize_dequantize(
        torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


def test_ef_compress_grads_over_five_steps_matches_reference():
    """Five steps of gradients drawn per step: the compressed gradients
    and the residual carried between steps, bit for bit."""
    shapes = {"w": (64, 96), "b": (96,), "e": (3, 2049)}
    jstate = jax_adam.adamw_init({k: jnp.zeros(s) for k, s in shapes.items()},
                                 grad_compression=True)
    tstate = adam.adamw_init({k: torch.zeros(s) for k, s in shapes.items()},
                             grad_compression=True)
    for step in range(5):
        rng = np.random.default_rng(step)
        g = {k: rng.standard_normal(s).astype(np.float32) * 1e-2
             for k, s in shapes.items()}
        jg, jstate = ref.ef_compress_grads(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        tg, tstate = compression.ef_compress_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        for k in shapes:
            assert np.array_equal(tg[k].numpy(), np.asarray(jg[k])), (step, k)
            assert np.array_equal(tstate.ef[k].numpy(),
                                  np.asarray(jstate.ef[k])), (step, k)
    assert any(t.abs().max() > 0 for t in tstate.ef.values())


def test_ef_compress_grads_without_a_residual_starts_from_zero():
    g = {"w": _values(4096, seed=7).reshape(64, 64)}
    jg, jst = ref.ef_compress_grads({"w": jnp.asarray(g["w"])},
                                    jax_adam.adamw_init({"w": jnp.zeros(
                                        (64, 64))}))
    tg, tst = compression.ef_compress_grads(
        {"w": torch.from_numpy(g["w"])},
        adam.adamw_init({"w": torch.zeros(64, 64)}))
    assert np.array_equal(tg["w"].numpy(), np.asarray(jg["w"]))
    assert np.array_equal(tst.ef["w"].numpy(), np.asarray(jst.ef["w"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wire_bytes_ratio_matches_reference(dtype):
    assert compression.wire_bytes_ratio(getattr(torch, dtype)) \
        == ref.wire_bytes_ratio(getattr(jnp, dtype))


def test_adamw_init_with_compression_matches_reference():
    params = {"a": jnp.zeros((3, 5), jnp.bfloat16), "b": jnp.zeros((7,))}
    want = jax_adam.adamw_init(params, use_master=True,
                               grad_compression=True)
    got = adam.adamw_init({"a": torch.zeros((3, 5), dtype=torch.bfloat16),
                           "b": torch.zeros(7)}, use_master=True,
                          grad_compression=True)
    for k in params:
        assert got.ef[k].dtype == torch.float32
        assert tuple(got.ef[k].shape) == want.ef[k].shape
        assert got.master[k].dtype == torch.float32
    assert adam.adamw_init({"b": torch.zeros(7)}).ef == ()


def test_adam_state_from_jax_carries_the_residual():
    from repro.configs import get_config as jax_config
    from repro.models import transformer as jax_tf
    jcfg = jax_config("tinyllama-1.1b").reduced(n_layers=1)
    params, _ = jax_tf.init_model(jcfg, jax.random.PRNGKey(0))
    state = jax_adam.adamw_init(params, grad_compression=True)
    ef = jax.tree.map(lambda p: jnp.full(p.shape, 0.25, jnp.float32), params)
    state = state._replace(ef=ef)
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            get_config("tinyllama-1.1b").reduced(n_layers=1),
                            "cpu")
    got = adam_state_from_jax(jax.tree.map(np.asarray, state), model)
    assert set(got.ef) == set(dict(model.named_parameters()))
    assert all(torch.equal(t, torch.full_like(t, 0.25))
               for t in got.ef.values())
    plain = adam_state_from_jax(jax.tree.map(np.asarray, jax_adam.adamw_init(
        params)), model)
    assert plain.ef == ()
