"""The port's Mixture-of-Experts slice against the JAX package, on the CPU.

``models/moe.py`` (router, scatter and dense paths, shared expert) and the
three configurations it unlocks, reduced and in fp32: Moonlight-16B-A3B
(64 experts top-6 at full width; 8 top-2 reduced), Kimi-K2 (a dense prefix
layer and a shared expert) and Jamba-1.5-Large (the 8-layer Mamba/attention
block with MoE on every other layer).  Weights cross over with
``params_from_jax``; inputs come from numpy seeds.  Tolerances:

* the router: the same experts exactly, weights and aux loss rtol 1e-5
  (one fp32 product and softmax);
* the MoE layer: rtol 2e-4, atol 2e-5, the reference's own
  (``tests/test_models.py:80``);
* whole models: ``test_torch_forward.py``'s logits and loss 1e-4, decode
  1e-4, and a train step's loss rtol 1e-4 and parameters rtol 2e-2, atol
  2e-4; gradients rtol 1e-4 and atol 1e-5 of the largest gradient of the
  model (``grad_atol``).  ``test_torch_forward.py`` holds TinyLlama's
  gradients, which reach 0.34, at atol 1e-6, and ``test_torch_ssm.py``
  holds Mamba-2's at 1e-5 of each leaf's largest value.  Here Kimi-K2's
  prefix attention gradients reach 0.84 and differ from the reference's by
  up to 2.4e-6, and Jamba's 8-layer block, whose gradients reach 7.7,
  differs by up to 5.2e-5 in its Mamba leaves; the same block with every
  FFN dense differs likewise (up to 2.7x each leaf's 1e-5 of its largest
  value), so the gap is fp32 sums in other orders through 8 layers, not
  the MoE path;
* a TENSILE-scheduled step against the unscheduled one: bit for bit.

Also the sliced ``dense_init`` draw.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro.configs import get_config as jax_config
from repro.launch import steps as jax_steps
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.models.registry import get_model as jax_get_model
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import params_from_jax
from repro_torch.launch import steps
from repro_torch.launch.steps import build_functional_train_step
from repro_torch.models import layers, moe
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim import adam

MOE_ARCHS = ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b"]
MOE_TOL = dict(rtol=2e-4, atol=2e-5)
D, E, F, K = 32, 8, 64, 2


def grad_atol(grads) -> float:
    """1e-5 of the largest gradient of the model (see the docstring)."""
    return 1e-5 * max(float(np.abs(np.asarray(g)).max()) for g in grads)


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


def _moe_params(seed=0, n_shared=0, act="swiglu"):
    """The reference's ``init_moe`` tree as numpy, and the port's."""
    from repro.models.layers import ParamBuilder
    b = ParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    jax_moe.init_moe(b, D, E, F, act, n_shared)
    jp = _np_tree(b.params)
    return jp, {k: torch.from_numpy(v.copy()) for k, v in jp.items()}


def _x(b=2, s=24, seed=1, shift=0.0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, D), dtype=np.float32) + np.float32(shift)


# ------------------------------------------------------------- the layer
def test_moe_tree_has_the_reference_leaves():
    for n_shared in (0, 1):
        jp, _ = _moe_params(n_shared=n_shared)
        got = moe.MoE(D, E, F, "swiglu", n_shared, dtype=torch.float32,
                      device="meta")
        assert {k: tuple(v.shape) for k, v in got.named_parameters()} \
            == {k: v.shape for k, v in jp.items()}


def test_router_matches_reference():
    jp, tp = _moe_params()
    x2d = _x().reshape(-1, D)
    jw, je, jaux = jax_moe._router(jp, jnp.asarray(x2d), K)
    tw, te, taux = moe._router(tp, torch.from_numpy(x2d), K)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert tw.dtype == torch.float32


def _biased(jp, tp):
    """A router that sends nearly every token to experts 0 and 1 (the
    inputs share a mean of +1 along every axis)."""
    bias = np.zeros((D, E), np.float32)
    bias[:, :2] = 1.0
    jp = dict(jp, router=jp["router"] + bias)
    return jp, dict(tp, router=torch.from_numpy(jp["router"].copy()))


@pytest.mark.parametrize("capacity_factor,overflow",
                         [(8.0, False), (1.0, True)])
def test_scatter_matches_reference(capacity_factor, overflow):
    """capacity_factor 8: nothing is dropped.  capacity_factor 1 with a
    biased router at 512 routed rows: capacity 64, rounded up to 128, and
    experts 0 and 1 overflow; the rows dropped must be the reference's
    (the earliest rows in token-major order are kept), or the outputs of
    the tokens whose rows differ would differ."""
    jp, tp = _moe_params()
    if overflow:
        jp, tp = _biased(jp, tp)
        x = _x(2, 128, shift=1.0)
    else:
        x = _x()
    kw = dict(top_k=K, n_experts=E, capacity_factor=capacity_factor,
              act="swiglu")
    want, jaux = jax_moe.moe_apply_scatter(jp, jnp.asarray(x), **kw)
    got, aux = moe.moe_apply_scatter(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    _, experts, _ = moe._router(tp, torch.from_numpy(x).reshape(-1, D), K)
    t = x.shape[0] * x.shape[1]
    cap = moe.capacity_of(t, K, E, capacity_factor)
    expert_flat, slot, keep = moe.dispatch_slots(experts, cap)
    counts = torch.bincount(expert_flat, minlength=E)
    assert set(torch.nonzero(counts > cap).flatten().tolist()) \
        == ({0, 1} if overflow else set())
    assert int((~keep).sum()) == int((counts - cap).clamp(min=0).sum())
    if overflow:
        # each overflowing expert keeps its first ``cap`` rows in
        # token-major order, in slots 0 .. cap - 1 in that order
        for e in (0, 1):
            rows = torch.nonzero(expert_flat == e).flatten()
            assert keep[rows[:cap]].all() and not keep[rows[cap:]].any()
            assert torch.equal(slot[rows[:cap]], torch.arange(cap))
            assert (slot[rows[cap:]] == cap).all()
        # a different choice of rows gives different outputs: the
        # tolerance above tells the reference's drops from others
        late = moe.moe_apply_scatter(tp, torch.from_numpy(
            x[::-1, ::-1].copy()), **kw)[0].numpy()[::-1, ::-1]
        assert not np.allclose(late, np.asarray(want), **MOE_TOL)


@pytest.mark.parametrize("n_shared", [0, 1])
def test_dense_matches_scatter(n_shared):
    """With capacity high enough to drop nothing, the scatter path is the
    dense path (``tests/test_models.py:67-82``), with and without a shared
    expert; the dense path is the reference's too."""
    jp, tp = _moe_params(n_shared=n_shared)
    x = torch.from_numpy(_x())
    dense, aux1 = moe.moe_apply_dense(tp, x, top_k=K, n_experts=E,
                                      act="swiglu")
    scatter, aux2 = moe.moe_apply_scatter(tp, x, top_k=K, n_experts=E,
                                          capacity_factor=8.0, act="swiglu")
    np.testing.assert_allclose(dense.numpy(), scatter.numpy(), **MOE_TOL)
    np.testing.assert_allclose(float(aux1), float(aux2), rtol=1e-5)
    want, _ = jax_moe.moe_apply_dense(jp, jnp.asarray(x.numpy()), top_k=K,
                                      n_experts=E, act="swiglu")
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), **MOE_TOL)
    if n_shared:
        shared = moe._shared_ffn(tp, x.reshape(-1, D), "swiglu")
        np.testing.assert_allclose(
            shared.numpy(), np.asarray(jax_moe._shared_ffn(
                jp, jnp.asarray(x.numpy().reshape(-1, D)), "swiglu")),
            **MOE_TOL)


@pytest.mark.parametrize("impl", ["dense", "scatter", "a2a"])
def test_moe_apply_dispatches_like_the_reference(impl):
    """``a2a`` without a mesh is the scatter path, in both packages."""
    jp, tp = _moe_params()
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(),
                              d_model=D, n_experts=E, top_k=K, moe_d_ff=F,
                              moe_impl=impl)
    jcfg = dataclasses.replace(jax_config("moonshot-v1-16b-a3b").reduced(),
                               d_model=D, n_experts=E, top_k=K, moe_d_ff=F,
                               moe_impl=impl)
    x = _x()
    want, _ = jax_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    got, _ = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)


def test_scatter_gradients_match_reference():
    """Through the dispatch (``index_put``) and combine (``index_select``)
    with rows dropped (2,048 routed rows over 8 experts at capacity 256:
    the busiest experts overflow): the gradients of a weighted sum of the
    output and the aux loss."""
    jp, tp = _moe_params()
    x = _x(2, 512)
    w = np.random.default_rng(3).standard_normal(x.shape, dtype=np.float32)
    kw = dict(top_k=K, n_experts=E, capacity_factor=1.0, act="swiglu")

    def jloss(p, xx):
        y, aux = jax_moe.moe_apply_scatter(p, xx, **kw)
        return jnp.sum(y * w) + aux

    jg = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply_scatter(leaves, xt, **kw)
    _, experts, _ = moe._router(tp, xt.detach().reshape(-1, D), K)
    assert not moe.dispatch_slots(experts, 256)[2].all()
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux,
                                list(leaves.values()) + [xt])
    want = {k: np.asarray(jg[0][k]) for k in leaves}
    want["x"] = np.asarray(jg[1])
    atol = grad_atol(want.values())
    for k, g in zip(list(leaves) + ["x"], grads):
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4, atol=atol,
                                   err_msg=k)


# -------------------------------------------------------- whole models
def _models(arch, seed=1):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    params, _ = jax_tf.init_model(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, params, params_from_jax(_np_tree(params), tcfg, "cpu")


def _batch(vocab, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s), dtype=np.int32),
            "labels": rng.integers(0, vocab, (b, s), dtype=np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_loss_and_gradients_match_reference(arch):
    jcfg, tcfg, params, model = _models(arch)
    assert any(spec.ffn == "moe" for spec in tcfg.block)
    batch = _batch(tcfg.vocab_size)
    want, jaux = jax_tf.forward(params, batch["tokens"], jcfg)
    api = get_model(tcfg, "cpu")
    with torch.no_grad():
        got, aux = api.forward(model, _torch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4)
    assert float(aux) > 0

    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_tf.loss_fn(p, batch, jcfg))(params)
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
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4, atol=1e-4)
    want_g = _flat(jgrads)
    assert set(grads) == set(want_g)
    atol = grad_atol(want_g.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[k], rtol=1e-4,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_reference(arch):
    """6 decode steps from an empty cache (T = 2 routed tokens a step)."""
    jcfg, tcfg, params, model = _models(arch)
    api = get_model(tcfg, "cpu")
    jcache, _ = jax_tf.init_cache(jcfg, 2, 8)
    tcache = api.init_cache(2, 8)
    step = jax.jit(lambda p, c, t, i: jax_tf.decode_step(p, jcfg, t, c, i))
    rng = np.random.default_rng(1)
    for i in range(6):
        tok = rng.integers(0, tcfg.vocab_size, (2, 1), dtype=np.int32)
        jlogits, jcache = step(params, jcache, tok, i)
        with torch.inference_mode():
            tlogits, tcache = api.decode(model, {"tokens": torch.from_numpy(
                tok)}, tcache, i)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_matches_reference(arch):
    jcfg, tcfg, params, model = _models(arch)
    batch = _batch(tcfg.vocab_size, b=4, s=32)
    jstep = jax_steps.build_train_step(jax_get_model(jcfg), None,
                                       jax_steps.TrainStepConfig())
    jp, _, jm = jax.jit(jstep)(params, jax_steps.opt_state_for(params),
                               batch)
    step = steps.build_train_step(get_model(tcfg, "cpu"))
    _, opt, m = step(model, steps.opt_state_for(model), _torch(batch))
    assert int(opt.step) == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4, atol=1e-4)
    want = _flat(_np_tree(jp))
    for k, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[k], rtol=2e-2, atol=2e-4,
                                   err_msg=k)


def test_model_builds_every_moe_leaf_under_the_reference_names():
    """Kimi-K2's prefix layer is dense (``mlp``), its block layer MoE with
    a shared expert (``moe.shared_*``), stacked on the repeats axis."""
    cfg = get_config("kimi-k2-1t-a32b").reduced()
    names = dict(TransformerLM(cfg, device="meta").named_parameters())
    assert "prefix0.mlp.wi" in names and "prefix0.moe.wi" not in names
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    assert tuple(names["blocks.layer0.moe.wi"].shape) == (1, e, d, f)
    assert tuple(names["blocks.layer0.moe.shared_wo"].shape) == (1, f, d)
    jamba = get_config("jamba-1.5-large-398b").reduced()
    names = dict(TransformerLM(jamba, device="meta").named_parameters())
    for i, spec in enumerate(jamba.block):
        assert (f"blocks.layer{i}.moe.router" in names) == (spec.ffn == "moe")


# ------------------------------------------------------ under TENSILE
def test_captured_moe_step_runs_bit_identical_under_a_tensile_plan():
    """``capture_train_step`` of reduced Moonlight's functional step gives
    a graph without mutation (the dispatch's index ops included), and the
    executor under a ``tensile`` plan at 0.7 of its planned peak returns
    the unscheduled step's outputs bit for bit."""
    cfg = get_config("moonshot-v1-16b-a3b").reduced(remat="none")
    api = get_model(cfg, "cpu")
    params = dict(api.init(torch.Generator().manual_seed(0))
                  .named_parameters())
    batch = api.input_specs(ShapeSpec("s", 64, 2, "train"), abstract=False)
    args = (params, adam.adamw_init(params), batch)
    seq, gm = tc.capture_train_step(build_functional_train_step(api), *args)
    assert not any(getattr(n.target, "_schema", None) is not None
                   and n.target._schema.name.endswith("_")
                   for n in gm.graph.nodes if n.op == "call_function")
    names = {op.name for op in seq.operators}
    assert {"sort", "index_put", "index_select"} <= names
    prof = tc.MachineProfile()
    unsched = tc.simulate([seq], None, prof, iterations=1).peak_bytes
    scfg = tc.SchedulerConfig(memory_budget_bytes=int(0.7 * unsched))
    ms = tc.MemoryScheduler(prof, scfg, pipeline=tc.build_pipeline(
        "tensile", prof, scfg))
    ms.register_job(seq)
    plan = ms.schedule().plans[seq.job_id]
    assert plan.events
    base = tc.FxExecutor(gm, seq, None).run(*args)
    ex = tc.FxExecutor(gm, seq, plan)
    out = ex.run(*args)
    assert ex.stats.swap_out_count > 0 and ex.stats.peak_bytes < unsched
    assert all(torch.equal(a, b) for a, b in zip(out, base))


# ------------------------------------------------- the sliced draw
def test_leaves_under_the_draw_limit_are_drawn_as_before():
    """One float32 draw, scaled and cast: ``torch.randn(...) * scale`` bit
    for bit from the same generator; and every leaf of full-width
    TinyLlama-1.1B and Mamba-2 780M is under the limit, so their weights
    from a seed are what they were."""
    for dtype in (torch.float32, torch.bfloat16):
        got = layers.dense_init(torch.Generator().manual_seed(3), (64, 48),
                                dtype, "cpu", lead=(3,))
        want = (torch.randn((3, 64, 48), generator=torch.Generator()
                            .manual_seed(3)) * (1 / np.sqrt(64))).to(dtype)
        assert got.dtype == dtype and torch.equal(got, want)
    for arch in ("tinyllama-1.1b", "mamba2-780m"):
        lm = TransformerLM(get_config(arch), device="meta")
        assert all(p.numel() * 4 <= layers.DRAW_LIMIT_BYTES
                   for p in lm.parameters())


def test_a_leaf_over_the_draw_limit_is_drawn_in_slices(monkeypatch):
    """Over the limit, slices over as few leading axes as fit, each drawn
    in float32 and cast into the leaf: (2, 4, 64, 256) at a limit of
    80 KiB takes slices of (64, 256) (64 KiB) over the first two axes.
    The std is the scale's within 1 %, and the slices are the generator's
    draws in order."""
    monkeypatch.setattr(layers, "DRAW_LIMIT_BYTES", 80 << 10)
    shape, scale = (4, 64, 256), 1 / np.sqrt(4)
    got = layers.dense_init(torch.Generator().manual_seed(5), shape,
                            torch.bfloat16, "cpu", lead=(2,))
    assert got.shape == (2,) + shape and got.dtype == torch.bfloat16
    assert abs(float(got.float().std()) / scale - 1) < 0.01
    gen = torch.Generator().manual_seed(5)
    want = torch.stack([(torch.randn((64, 256), generator=gen) * scale)
                        .to(torch.bfloat16) for _ in range(8)])
    assert torch.equal(got.reshape(8, 64, 256), want)
