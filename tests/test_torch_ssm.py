"""The port's Mamba-2 against the JAX package's, on the CPU.

Inputs come from numpy with fixed seeds and go to both packages; weights
are drawn by the JAX package and moved across with ``params_from_jax``.
The JAX kernel runs in interpret mode, as its own tests run it.
Tolerances, fp32 throughout:

* the SSD oracle, the chunked SSD and its gradients against the reference
  1e-4, the kernel's own tolerance (``tests/test_kernels.py:51-68``): a
  gradient for dt sums Q x P x N terms of both signs, so it is held like
  the SSD's outputs, not like the model's gradients below; against the
  sequential recurrence the reference's 2e-3 (``tests/test_models.py``);
* the mixer, forward logits and loss 1e-4, and a train step rtol 2e-2,
  atol 2e-4 on the new parameters, as ``test_torch_forward.py`` holds the
  attention model (sums in different orders move fp32 results by a few
  ulps per layer); gradients rtol 1e-4 and atol 1e-5 of each leaf's
  largest value, which is the attention model's atol 1e-6 on its leaves
  of about 0.1 (the Mamba leaves reach 0.9, and differ by about 5e-6 of
  their scale);
* decode logits 1e-4 and cache leaves atol 1e-5 over 6 steps, as
  ``test_torch_model.py`` holds the O(1) KV leaves; the fp32 SSM state
  reaches about 100 in 6 steps, where 1e-5 is about one ulp, so each leaf
  is held to 1e-5 of its largest value; the forward against the port's own
  decode 2e-3;
* serving: tokens, decision traces and reports exactly (greedy argmax over
  logits that agree to about 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import MachineProfile as JaxProfile
from repro.core import MemoryEngine as JaxMemoryEngine
from repro.kernels.ops import ssd_intra_chunk as jax_ssd_intra_chunk
from repro.launch import steps as jax_steps
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf
from repro.models.layers import ParamBuilder
from repro.models.registry import get_model as jax_get_model
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import params_from_jax
from repro_torch.core import MachineProfile, MemoryEngine
from repro_torch.kernels import kv_block_copy as kbc
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.ref import ssd_intra_chunk_ref
from repro_torch.launch import steps
from repro_torch.models import ssm, transformer
from repro_torch.models.registry import get_model
from repro_torch.serving import ServingEngine, make_trace
from repro_torch.serving.engine import tree_leaves

ARCH = "mamba2-780m"
SWEEP = [(2, 3, 64, 4, 16, 32), (1, 2, 128, 2, 64, 128),
         (1, 5, 32, 8, 64, 16)]


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
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _models(n_layers=1, seed=1, **overrides):
    jcfg, tcfg = _cfgs(n_layers=n_layers, **overrides)
    params, _ = jax_tf.init_model(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, params, params_from_jax(_np_tree(params), tcfg, "cpu")


def _batch(vocab, b=2, s=40, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s), dtype=np.int32),
            "labels": rng.integers(0, vocab, (b, s), dtype=np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _softplus(a):
    return np.log1p(np.exp(a)).astype(np.float32)


def _intra_inputs(b, nc, q, h, p, n, seed=0):
    """The reference test's draws, from numpy: normal x, B and C,
    softplus-normal dt and minus softplus-normal dA."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, nc, q, h, p), dtype=np.float32),
            _softplus(rng.standard_normal((b, nc, q, h), dtype=np.float32)),
            -_softplus(rng.standard_normal((b, nc, q, h), dtype=np.float32)),
            rng.standard_normal((b, nc, q, n), dtype=np.float32),
            rng.standard_normal((b, nc, q, n), dtype=np.float32))


def _scan_inputs(b=2, s=160, h=4, p=16, n=32, seed=0, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p), dtype=np.float32),
            _softplus(rng.standard_normal((b, s, h), dtype=np.float32))
            * np.float32(dt_scale),
            -np.exp(rng.standard_normal(h, dtype=np.float32) * 0.5),
            rng.standard_normal((b, s, n), dtype=np.float32),
            rng.standard_normal((b, s, n), dtype=np.float32))


# ---------------------------------------------------------------- kernel
@pytest.mark.parametrize("shape", SWEEP)
def test_ssd_intra_chunk_ref_matches_the_reference_kernel(shape):
    arrays = _intra_inputs(*shape)
    y_j, st_j = jax_ssd_intra_chunk(*map(jnp.asarray, arrays))
    y_t, st_t = ssd_intra_chunk_ref(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), rtol=1e-4,
                               atol=1e-4)
    # the wrapper on CPU tensors is the plain version and launches nothing
    n0 = ssd_scan.ssd_intra_chunk_fwd.launches
    y_w, st_w = ssd_scan.ssd_intra_chunk_fwd(*map(torch.from_numpy, arrays))
    assert torch.equal(y_w, y_t) and torch.equal(st_w, st_t)
    assert ssd_scan.ssd_intra_chunk_fwd.launches == n0


def test_ssd_kernel_wrapper_checks_its_inputs():
    x, dt, da, b, c = map(torch.from_numpy, _intra_inputs(1, 1, 8, 2, 4, 3))
    with pytest.raises(ValueError, match="chunk length"):
        ssd_scan.ssd_intra_chunk_fwd(*map(torch.from_numpy, _intra_inputs(
            1, 1, 257, 1, 4, 3)))
    with pytest.raises(ValueError, match="dtc and da"):
        ssd_scan.ssd_intra_chunk_fwd(x, dt[:, :, :4], da, b, c)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan.ssd_intra_chunk_fwd(x, dt.double(), da, b, c)
    with pytest.raises(TypeError, match="xc dtype"):
        ssd_scan.ssd_intra_chunk_fwd(x.half(), dt, da, b, c)
    with pytest.raises(RuntimeError, match="forward-only"):
        ssd_scan.ssd_intra_chunk_fwd(x.requires_grad_(True), dt, da, b, c)
    with torch.no_grad():
        y, st = ssd_scan.ssd_intra_chunk_fwd(x, dt, da, b, c)
    assert y.shape == (1, 1, 8, 2, 4) and st.shape == (1, 1, 2, 4, 3)


# ------------------------------------------------------------------ scan
@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssd_chunked_matches_the_reference(use_kernel):
    """A ragged length (160 over chunks of 64) and an initial state."""
    x, dt, a, bb, cc = _scan_inputs()
    h0 = np.random.default_rng(3).standard_normal((2, 4, 16, 32),
                                                  dtype=np.float32)
    y_j, fin_j = jax_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bb, cc)),
                                     64, initial_state=jnp.asarray(h0))
    with torch.no_grad():
        y_t, fin_t = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bb,
                                                             cc)),
                                     64, initial_state=torch.from_numpy(h0),
                                     use_kernel=use_kernel)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(fin_t.numpy(), np.asarray(fin_j), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssd_chunked_matches_sequential_recurrence(use_kernel):
    x, dt, a, bb, cc = _scan_inputs()
    with torch.no_grad():
        y, fin = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bb, cc)),
                                 64, use_kernel=use_kernel)
    b, s, h, p = x.shape
    st = np.zeros((b, h, p, bb.shape[-1]))
    ys = np.zeros((b, s, h, p))
    for t in range(s):
        dec = np.exp(dt[:, t] * a[None])
        st = st * dec[..., None, None] + np.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], bb[:, t], x[:, t])
        ys[:, t] = np.einsum("bn,bhpn->bhp", cc[:, t], st)
    np.testing.assert_allclose(y.numpy(), ys, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(fin.numpy(), st, rtol=2e-3, atol=2e-3)




def test_ssd_gradients_match_the_reference():
    x, dt, a, bb, cc = _scan_inputs(s=96)

    def jloss(x, dt, bb, cc):
        return jax_ssm.ssd_chunked(x, dt, jnp.asarray(a), bb, cc, 32)[0].sum()

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, dt, bb, cc)))
    leaves = [torch.from_numpy(t).requires_grad_(True)
              for t in (x, dt, bb, cc)]
    y, _ = ssm.ssd_chunked(leaves[0], leaves[1], torch.from_numpy(a),
                           leaves[2], leaves[3], 32)
    got = torch.autograd.grad(y.sum(), leaves)
    for g, w in zip(got, want):      # the SSD's own tolerance
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_ssd_gradient_stays_finite_where_the_reference_overflows():
    """At full width the decay's log reaches -100s within a chunk; the
    reference's ``exp`` of the masked upper triangle overflows and its
    backward gives NaN for dt (ROADMAP §3).  The port masks before the
    ``exp``: the same forward, finite gradients."""
    x, dt, a, bb, cc = _scan_inputs(s=64, dt_scale=3.0)
    a = -np.ones_like(a)
    assert np.cumsum(dt * a, axis=1).min() < -89     # exp(89) > fp32 max

    def jloss(dt):
        return jax_ssm.ssd_chunked(*map(jnp.asarray, (x,)), dt,
                                   jnp.asarray(a), jnp.asarray(bb),
                                   jnp.asarray(cc), 64)[0].sum()

    assert not np.isfinite(np.asarray(jax.grad(jloss)(jnp.asarray(dt)))).all()
    dt_t = torch.from_numpy(dt).requires_grad_(True)
    y, _ = ssm.ssd_chunked(torch.from_numpy(x), dt_t, torch.from_numpy(a),
                           torch.from_numpy(bb), torch.from_numpy(cc), 64)
    (g,) = torch.autograd.grad(y.sum(), [dt_t])
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(
        jax_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bb, cc)), 64)[0]),
        rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ mixer/model
@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba2_block_matches_the_reference(use_kernel):
    jcfg, tcfg = _cfgs()
    b = ParamBuilder(jax.random.PRNGKey(2), jnp.float32)
    jax_ssm.init_mamba2(b, jcfg)
    x = np.random.default_rng(4).standard_normal((2, 72, tcfg.d_model),
                                                 dtype=np.float32)
    want = jax_ssm.mamba2_block(b.params, jnp.asarray(x), jcfg)
    p = {k: torch.from_numpy(v) for k, v in _flat(b.params).items()}
    with torch.no_grad():
        got = ssm.mamba2_block(p, torch.from_numpy(x), dataclasses.replace(
            tcfg, use_flash_kernel=use_kernel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_init_and_cache_follow_the_reference_layout():
    """Same leaves, shapes, dtypes and init scale rule (the draws differ);
    the cache tree has the reference's structure, SSM leaves stacked
    ``(n_repeats, B, ...)``."""
    jcfg, tcfg = _cfgs(n_layers=3)
    jparams = _flat(_np_tree(jax_tf.init_model(jcfg,
                                               jax.random.PRNGKey(0))[0]))
    state = transformer.init_model(tcfg, torch.Generator().manual_seed(0),
                                   "cpu").state_dict()
    assert set(state) == set(jparams)
    assert "blocks.layer0.mamba.a_log" in state
    for key, want in jparams.items():
        got = state[key].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if want.std() == 0:
            np.testing.assert_array_equal(got, want)
        else:
            assert got.std() == pytest.approx(want.std(), rel=0.15), key
    jcache, _ = jax_tf.init_cache(jcfg, 2, 10)
    tcache = transformer.init_cache(tcfg, 2, 10, "cpu")
    assert jax.tree_util.tree_structure(jcache) \
        == jax.tree_util.tree_structure(jax.tree.map(lambda _: 0, tcache))
    for t, j in zip(tree_leaves(tcache), jax.tree_util.tree_leaves(jcache)):
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}"
    assert tcache["blocks"]["layer0"]["state"].shape == (3, 2, 16, 16, 32)


def test_params_from_jax_carries_the_mamba_subtree():
    jcfg, tcfg = _cfgs(n_layers=2, dtype="bfloat16")
    params, _ = jax_tf.init_model(jcfg, jax.random.PRNGKey(3))
    want = _flat(_np_tree(params))
    state = params_from_jax(_np_tree(params), tcfg, "cpu").state_dict()
    assert set(state) == set(want)
    for key, w in want.items():
        np.testing.assert_array_equal(
            state[key].view(torch.uint16).numpy(), w.view(np.uint16))


@pytest.mark.parametrize("n_layers,flash", [(1, False), (2, False), (2, True)])
def test_forward_matches_the_reference(n_layers, flash):
    jcfg, tcfg, params, model = _models(n_layers)
    batch = _batch(tcfg.vocab_size)
    want, _ = jax_tf.forward(params, batch["tokens"], jcfg)
    api = get_model(dataclasses.replace(tcfg, use_flash_kernel=flash), "cpu")
    got = steps.build_prefill_step(api)(model, _torch(batch))
    assert got.shape == (2, 40, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_loss_and_gradients_match_the_reference():
    jcfg, tcfg, params, model = _models(2)
    batch = _batch(tcfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_tf.loss_fn(p, batch, jcfg))(params)
    api = get_model(tcfg, "cpu")
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    try:
        loss = api.loss(model, _torch(batch))
        grads = dict(zip(named, torch.autograd.grad(loss,
                                                    list(named.values()))))
    finally:
        for p in named.values():
            p.requires_grad_(False)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                               atol=1e-4)
    want = _flat(jgrads)
    assert set(grads) == set(want)
    for k, g in grads.items():
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)


def test_train_step_matches_the_reference():
    jcfg, tcfg, params, model = _models(2)
    batch = _batch(tcfg.vocab_size, b=4, s=32)
    jstep = jax_steps.build_train_step(jax_get_model(jcfg), None,
                                       jax_steps.TrainStepConfig())
    jp, _, jm = jax.jit(jstep)(params, jax_steps.opt_state_for(params),
                               batch)
    step = steps.build_train_step(get_model(tcfg, "cpu"),
                                  steps.TrainStepConfig())
    _, opt, m = step(model, steps.opt_state_for(model), _torch(batch))
    assert int(opt.step) == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    want = _flat(_np_tree(jp))
    for k, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[k], rtol=2e-2, atol=2e-4,
                                   err_msg=k)


def test_input_specs_serve_the_ssm_family():
    _, tcfg = _cfgs()
    api = get_model(tcfg, "cpu")
    train = api.input_specs(ShapeSpec("t", 32, 2, "train"), abstract=False)
    assert set(train) == {"tokens", "labels"}
    assert train["tokens"].shape == (2, 32)
    prefill = api.input_specs(ShapeSpec("p", 32, 2, "prefill"))
    assert set(prefill) == {"tokens"} and prefill["tokens"].is_meta


# ---------------------------------------------------------------- decode
def test_decode_matches_the_reference():
    jcfg, tcfg, params, model = _models(2)
    rng = np.random.default_rng(0)
    batch, max_len = 3, 8
    jcache, _ = jax_tf.init_cache(jcfg, batch, max_len)
    start = [rng.standard_normal(x.shape).astype(np.float32) * 0.5
             for x in jax.tree_util.tree_leaves(jcache)]
    jcache = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jcache), [jnp.asarray(x)
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
        scale = max(1.0, float(np.abs(np.asarray(j)).max()))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5 * scale)


def test_forward_matches_own_decode():
    """The parallel forward over a prompt gives the logits of one-token
    decode steps over it (the recurrent state carries the chunked scan)."""
    _, tcfg, _, model = _models(2)
    api = get_model(tcfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 100, (2, 40), dtype=np.int32))
    with torch.inference_mode():
        par, _ = api.forward(model, {"tokens": toks})
        cache = api.init_cache(2, 8)
        outs = []
        for i in range(40):
            lg, cache = api.decode(model, {"tokens": toks[:, i:i + 1]},
                                   cache, i)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(par.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)


# --------------------------------------------------------------- serving
PROMPT, GEN = 4, 8
MAX_LEN = PROMPT + GEN
PORT_PROFILE = dict(host_link_bw=16e9, host_link_latency=15e-6,
                    dma_batch_overhead=2e-6, compute_flops=5e10, mem_bw=1e10)


@pytest.fixture(scope="module")
def engines():
    jeng = JaxServingEngine(ARCH, max_sequences=4, max_len=MAX_LEN, seed=0)
    teng = ServingEngine(ARCH, max_sequences=4, max_len=MAX_LEN, seed=0,
                         device="cpu")
    teng.params = params_from_jax(_np_tree(jeng.params), teng.cfg, "cpu")
    teng.prompt_for = jeng.prompt_for     # the reference's prompts, as-is
    return jeng, teng


@pytest.fixture(scope="module")
def trace6():
    return make_trace("poisson", 6, seed=0, prompt_len=PROMPT, gen_len=GEN)


def _budget(eng):
    return eng.bytes_per_token * (MAX_LEN * 2 + 2)   # about 2 of 4 slots


def test_engine_classifies_positionless_state_like_the_reference(engines):
    jeng, teng = engines
    assert teng.bytes_per_token == jeng.bytes_per_token
    assert [(a.batch, a.length) for a in teng._axes] \
        == [(a.batch, a.length) for a in jeng._axes] == [(1, None)] * 4


@pytest.mark.parametrize("batch_transfers", [False, True])
def test_engine_matches_the_reference(engines, trace6, batch_transfers):
    jeng, teng = engines
    budget = _budget(teng)
    mem_j = JaxMemoryEngine(JaxProfile(host_link_bw=16e9, compute_flops=5e10,
                                       mem_bw=1e10),
                            capacity_bytes=budget, trace=True)
    mem_t = MemoryEngine(MachineProfile(**PORT_PROFILE),
                         capacity_bytes=budget, trace=True)
    rep_j, out_j = jeng.serve(trace6, budget_bytes=budget, engine=mem_j,
                              batch_transfers=batch_transfers)
    g0, s0 = kbc.kv_block_gather.launches, kbc.kv_block_scatter.launches
    rep_t, out_t = teng.serve(trace6, budget_bytes=budget, engine=mem_t,
                              batch_transfers=batch_transfers)
    assert out_t == out_j
    assert mem_t.trace.keys() == mem_j.trace.keys()
    assert dataclasses.asdict(rep_t) == dataclasses.asdict(rep_j)
    assert rep_t.evictions > 0 and rep_t.oom_events == 0
    # the CPU path of the wrappers launches no kernel
    assert (kbc.kv_block_gather.launches,
            kbc.kv_block_scatter.launches) == (g0, s0)


def test_budgeted_run_is_bit_identical_to_the_unbudgeted_run(engines,
                                                             trace6):
    _, teng = engines
    _, golden = teng.serve(trace6, budget_bytes=None, schedule=False)
    assert len(golden) == 6 and all(len(t) == GEN for t in golden.values())
    for batch_transfers in (False, True):
        rep, out = teng.serve(trace6, budget_bytes=_budget(teng),
                              engine=MemoryEngine(
                                  MachineProfile(**PORT_PROFILE),
                                  capacity_bytes=_budget(teng), trace=True),
                              batch_transfers=batch_transfers)
        assert rep.oom_events == 0 and rep.evictions > 0
        assert out == golden
