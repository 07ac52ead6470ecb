"""The port's decoder LM against the JAX package's, on reduced TinyLlama.

Weights are drawn by the JAX package and moved across as numpy through
``repro_torch.convert.params_from_jax``; token ids and the starting cache
come from numpy with a fixed seed and go to both.  Tolerances (fp32):
logits rtol = atol = 1e-4 and cache atol = 1e-5 over 6 decode steps.  The
two packages sum in different orders (XLA's fused CPU kernels against
PyTorch's), which moves fp32 results by a few ulps per layer.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as jax_tf
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import tree_leaves

ARCH = "tinyllama-1.1b"


def _cfgs(**overrides):
    return (jax_config(ARCH).reduced(**overrides),
            get_config(ARCH).reduced(**overrides))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _as_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def test_configs_are_copies_of_the_reference():
    from repro.configs import list_configs as jax_list
    from repro_torch.configs import list_configs
    assert list_configs() == jax_list()
    for name in list_configs():
        assert dataclasses.asdict(get_config(name)) \
            == dataclasses.asdict(jax_config(name))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(dtype):
    jcfg, tcfg = _cfgs(n_layers=2, dtype=dtype)
    params, _ = jax_tf.init_model(jcfg, jax.random.PRNGKey(3))
    np_params = _flat(_np_tree(params))
    model = params_from_jax(_np_tree(params), tcfg, "cpu")
    state = model.state_dict()
    assert set(state) == set(np_params)
    for key, want in np_params.items():
        got = state[key]
        assert tuple(got.shape) == want.shape, key
        assert str(got.dtype) == f"torch.{dtype}", key
        if dtype == "bfloat16":
            np.testing.assert_array_equal(_as_np(got), want.view(np.uint16))
        else:
            np.testing.assert_array_equal(_as_np(got), want)


def test_init_matches_the_reference_layout_and_scale_rule():
    """Same shapes, dtypes and init scale per leaf (fan-in is the first
    per-layer axis: ``wo`` (H, Dh, d) scales by 1/sqrt(H)); the draws
    themselves differ.  Std within 15 % of the reference's."""
    jcfg, tcfg = _cfgs(n_layers=2)
    jparams = _flat(_np_tree(jax_tf.init_model(jcfg,
                                               jax.random.PRNGKey(0))[0]))
    model = transformer.init_model(tcfg, torch.Generator().manual_seed(0),
                                   "cpu")
    state = model.state_dict()
    assert set(state) == set(jparams)
    for key, want in jparams.items():
        got = state[key].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if want.std() == 0:
            np.testing.assert_array_equal(got, want)
        else:
            assert got.std() == pytest.approx(want.std(), rel=0.15), key


def test_init_cache_matches_the_reference_tree():
    jcfg, tcfg = _cfgs(n_layers=3)
    jcache, _ = jax_tf.init_cache(jcfg, 2, 10)
    tcache = transformer.init_cache(tcfg, 2, 10, "cpu")
    jleaves = jax.tree_util.tree_leaves(jcache)
    tleaves = tree_leaves(tcache)
    assert [tuple(x.shape) for x in tleaves] == [x.shape for x in jleaves]
    assert tleaves[0].shape == (3, 2, 10, tcfg.n_kv_heads, tcfg.head_dim)
    assert jax.tree_util.tree_structure(jcache) \
        == jax.tree_util.tree_structure(jax.tree.map(lambda _: 0, tcache))


@pytest.mark.parametrize("n_layers", [1, 3])
def test_decode_step_matches_the_reference(n_layers):
    jcfg, tcfg = _cfgs(n_layers=n_layers)
    params, _ = jax_tf.init_model(jcfg, jax.random.PRNGKey(1))
    model = params_from_jax(_np_tree(params), tcfg, "cpu")
    rng = np.random.default_rng(0)
    batch, max_len = 3, 8
    jcache, _ = jax_tf.init_cache(jcfg, batch, max_len)
    start = [rng.standard_normal(x.shape).astype(np.float32) * 0.5
             for x in jax.tree_util.tree_leaves(jcache)]
    jcache = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jcache), [jax.numpy.asarray(x)
                                               for x in start])
    tcache = transformer.init_cache(tcfg, batch, max_len, "cpu")
    for leaf, x in zip(tree_leaves(tcache), start):
        leaf.copy_(torch.from_numpy(x))
    api = get_model(tcfg, "cpu")
    step = jax.jit(lambda p, c, t, i: jax_tf.decode_step(p, jcfg, t, c, i))
    for i in range(6):
        tok = rng.integers(0, tcfg.vocab_size, (batch, 1), dtype=np.int32)
        jlogits, jcache = step(params, jcache, tok, i)
        with torch.inference_mode():
            tlogits, tcache = api.decode(model, {"tokens":
                                                 torch.from_numpy(tok)},
                                         tcache, i)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
    for t, j in zip(tree_leaves(tcache), jax.tree_util.tree_leaves(jcache)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["mamba2-780m", "moonshot-v1-16b-a3b",
                                  "whisper-base"])
def test_unported_families_raise(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError):
        get_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
