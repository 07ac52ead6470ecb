"""The port's whisper slice against the JAX package, on the CPU.

``attention.cross_attention_block`` and ``models/whisper.py`` (encoder,
decoder, loss, decode step), reached through the registry, the step
builders, ``convert.params_from_jax``, TENSILE's capture and executor, the
data pipeline and the training launcher, on reduced whisper-base in fp32
(2 encoder layers, 1 decoder layer, d 128, 4 query and 2 kv heads of 32,
attn_chunk 64).  Weights are drawn by the JAX package and cross over as
numpy; audio frames, tokens and labels come from numpy seeds.  Encoder
lengths 96 (every attention on ``attend_full``) and 160 (the encoder and
the cross-attention on ``attend_chunked``).  Tolerances, as
``test_torch_forward.py`` holds the LM:

* one attention block rtol = atol = 1e-5;
* the encoder's output, logits, loss and decode logits 1e-4;
* gradients rtol 1e-4 and atol 1e-5 of the model's largest gradient
  (``grad_atol``, ``test_torch_moe.py``'s rule).  ``test_torch_forward.py``
  holds TinyLlama's gradients, which reach 0.34, at atol 1e-6; the
  encoder's here reach 0.94 and differ from the reference's by up to
  6.0e-6, while both packages' fp32 gradients lie 1e-6 to 7.9e-6 from the
  port's own float64 gradients (port 7.86e-6, reference 6.06e-6 on
  ``enc_blocks.attn.wk``): the gap is fp32 sums in other orders through
  the encoder, the cross-attention and back.  The cross-attention biases,
  which neither package reads, are exactly zero in both;
* a train step's loss rtol 1e-4 and parameters rtol 2e-2, atol 2e-4;
* a TENSILE-scheduled step against the unscheduled one: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro.configs import get_config as jax_config
from repro.data import pipeline as jax_pipeline
from repro.launch import steps as jax_steps
from repro.models import attention as jax_attn
from repro.models import whisper as jax_whisper
from repro.models.registry import get_model as jax_get_model
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import params_from_jax
from repro_torch.data import pipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import steps, train
from repro_torch.models import attention, whisper
from repro_torch.models.registry import get_model
from repro_torch.optim import adam

ARCH = "whisper-base"
XATTN_BIASES = [f"dec_blocks.xattn.{b}" for b in ("bq", "bk", "bv")]


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


def _models(seed=1, **overrides):
    jcfg = jax_config(ARCH).reduced(**overrides)
    tcfg = get_config(ARCH).reduced(**overrides)
    params, _ = jax_whisper.init_whisper(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, params, params_from_jax(_np_tree(params), tcfg, "cpu")


def _batch(cfg, b=2, s_enc=96, seed=0):
    rng = np.random.default_rng(seed)
    s_dec = max(s_enc // cfg.enc_seq_ratio, 8)
    return {"audio_feats": rng.standard_normal((b, s_enc, cfg.d_model),
                                               dtype=np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (b, s_dec),
                                   dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s_dec),
                                   dtype=np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def grad_atol(grads) -> float:
    """1e-5 of the largest gradient of the model (see the docstring)."""
    return 1e-5 * max(float(np.abs(np.asarray(g)).max()) for g in grads)


# ------------------------------------------------------ cross-attention
@pytest.mark.parametrize("sq,skv", [(24, 96), (40, 160), (160, 24)])
def test_cross_attention_block_matches_reference(sq, skv):
    """(24, 96): ``attend_full``; (40, 160) and (160, 24): ``attend_chunked``
    (the longer side passes 2 * attn_chunk), with GQA (4 query heads over
    2 kv heads)."""
    jcfg, tcfg, params, model = _models()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, sq, tcfg.d_model), dtype=np.float32)
    ctx = rng.standard_normal((2, skv, tcfg.d_model), dtype=np.float32)
    jp = jax.tree.map(lambda a: a[0], params["dec_blocks"]["xattn"])
    want = jax_attn.cross_attention_block(jp, jnp.asarray(x),
                                          jnp.asarray(ctx), cfg=jcfg)
    with torch.inference_mode():
        got = attention.cross_attention_block(
            model["dec_blocks"].at(0)["xattn"], torch.from_numpy(x),
            torch.from_numpy(ctx), cfg=tcfg)
    assert got.shape == (2, sq, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------- the model
def test_whisper_tree_has_the_reference_leaves():
    """Every key and shape of the reference's tree, full width on
    ``meta``: 6 encoder and 6 decoder layers stacked on axis 0."""
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    params, _ = jax_whisper.abstract_whisper(jcfg)
    want = {k: tuple(v.shape) for k, v in _flat_abstract(params).items()}
    got = {k: tuple(v.shape) for k, v in get_model(tcfg, "cpu").shell()
           .state_dict().items()}
    assert got == want
    assert got["enc_blocks.attn.wq"] == (6, 512, 8, 64)
    assert got["dec_blocks.xattn.bq"] == (6, 8, 64)
    assert all(p.device.type == "meta" for p in
               get_model(tcfg, "cpu").shell().parameters())


def _flat_abstract(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_abstract(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("s_enc", [96, 160])
def test_encode_matches_reference(s_enc):
    jcfg, tcfg, params, model = _models()
    batch = _batch(tcfg, s_enc=s_enc)
    want = jax.jit(lambda p, a: jax_whisper.encode(p, a, jcfg))(
        params, batch["audio_feats"])
    with torch.inference_mode():
        got = whisper.encode(model, torch.from_numpy(batch["audio_feats"]),
                             tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("s_enc", [96, 160])
def test_forward_matches_reference(flash, s_enc):
    """With ``use_flash_kernel`` the reference's decoder self-attention
    runs its Pallas kernel in interpret mode and the port's the kernel's
    wrapper, which takes its plain version on the CPU: one call per
    decoder layer, none for the encoder or the cross-attention."""
    jcfg, tcfg, params, model = _models(use_flash_kernel=flash)
    batch = _batch(tcfg, s_enc=s_enc)
    want, jaux = jax.jit(lambda p, b: jax_whisper.forward(p, b, jcfg))(
        params, batch)
    api = get_model(tcfg, "cpu")
    calls = []
    wrapped = fa.flash_attention_fwd

    def counted(*a, **kw):
        calls.append(kw.get("causal"))
        return wrapped(*a, **kw)

    attention.flash_attention_fwd = counted
    try:
        got = steps.build_prefill_step(api)(model, _torch(batch))
    finally:
        attention.flash_attention_fwd = wrapped
    assert calls == ([True] * tcfg.n_layers if flash else [])
    assert got.shape == (2, s_enc // 4, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    with torch.inference_mode():
        _, aux = api.forward(model, _torch(batch))
    assert float(aux) == float(jaux) == 0.0


def test_loss_matches_reference():
    jcfg, tcfg, params, model = _models()
    batch = _batch(tcfg, s_enc=160)
    batch["labels"][0, :5] = -1                         # masked tokens
    want = jax.jit(lambda p, b: jax_whisper.loss_fn(p, b, jcfg))(params,
                                                                 batch)
    with torch.no_grad():
        got = get_model(tcfg, "cpu").loss(model, _torch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("remat", ["block", "none"])
def test_gradients_match_reference(remat):
    """Every leaf's gradient, through checkpointed layers or not; the
    cross-attention biases get zeros (the reference's ``jax.grad`` gives
    exactly 0.0), where torch would raise for a leaf the loss never
    reads."""
    jcfg, tcfg, params, model = _models(remat=remat)
    batch = _batch(tcfg, s_enc=160)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_whisper.loss_fn(p, batch, jcfg)))(params)
    api = get_model(tcfg, "cpu")
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    try:
        loss = api.loss(model, _torch(batch))
        grads = steps._grads(loss, named)
    finally:
        for p in named.values():
            p.requires_grad_(False)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4, atol=1e-4)
    want = _flat(jgrads)
    assert set(grads) == set(want)
    atol = grad_atol(want.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4, atol=atol,
                                   err_msg=k)
    for k in XATTN_BIASES:
        assert not want[k].any() and not grads[k].any(), k
        assert grads[k].shape == named[k].shape


def test_grads_give_zeros_for_an_unused_leaf():
    """``steps._grads`` on a module with a parameter the loss never reads:
    zeros of its shape, and the used leaf's gradient as plain autograd
    gives it, bit for bit."""
    rng = np.random.default_rng(0)
    used = torch.from_numpy(rng.standard_normal((3, 4), dtype=np.float32))
    unused = torch.from_numpy(rng.standard_normal((5,), dtype=np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 3), dtype=np.float32))
    named = {"w": used.requires_grad_(True),
             "b": unused.requires_grad_(True)}
    loss = torch.tanh(x @ named["w"]).sum()
    (want,) = torch.autograd.grad(loss, [named["w"]], retain_graph=True)
    grads = steps._grads(loss, named)
    assert torch.equal(grads["w"], want)
    assert torch.equal(grads["b"], torch.zeros(5))


@pytest.mark.parametrize("s_enc", [96, 160])
def test_decode_matches_reference(s_enc):
    """4 decode steps from an empty cache against ``whisper.decode_step``
    on the same encoder output (numpy)."""
    jcfg, tcfg, params, model = _models()
    api = get_model(tcfg, "cpu")
    rng = np.random.default_rng(3)
    enc_out = rng.standard_normal((2, s_enc, tcfg.d_model), dtype=np.float32)
    jcache, _ = jax_whisper.init_cache(jcfg, 2, 8)
    tcache = api.init_cache(2, 8)
    assert tuple(tcache["self"]["k"].shape) == (
        tcfg.n_layers, 2, 8, tcfg.n_kv_heads, tcfg.head_dim)
    step = jax.jit(lambda p, c, t, i, e: jax_whisper.decode_step(
        p, jcfg, t, c, i, e))
    for i in range(4):
        tok = rng.integers(0, tcfg.vocab_size, (2, 1), dtype=np.int32)
        jlogits, jcache = step(params, jcache, tok, i, enc_out)
        with torch.inference_mode():
            tlogits, tcache = steps.build_serve_step(api)(
                model, tcache, {"tokens": torch.from_numpy(tok),
                                "enc_out": torch.from_numpy(enc_out)}, i)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tcache["self"]["k"].numpy(),
                               np.asarray(jcache["self"]["k"]), rtol=1e-5,
                               atol=1e-5)


def test_forward_matches_own_decode():
    """The parallel decoder over a prompt gives the logits of one-token
    decode steps over the same prompt and encoder output (2e-3, as
    ``test_torch_forward.py``)."""
    _, tcfg, _, model = _models()
    api = get_model(tcfg, "cpu")
    batch = _torch(_batch(tcfg, s_enc=160))
    toks = batch["tokens"][:, :12]
    with torch.inference_mode():
        enc_out = whisper.encode(model, batch["audio_feats"], tcfg)
        par = whisper.decode_train(model, toks, enc_out, tcfg)
        cache = api.init_cache(2, 16)
        outs = []
        for i in range(12):
            lg, cache = api.decode(model, {"tokens": toks[:, i:i + 1],
                                           "enc_out": enc_out}, cache, i)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(par.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)


def test_train_step_matches_reference():
    jcfg, tcfg, params, model = _models()
    batch = _batch(tcfg, b=4, s_enc=128)
    jstep = jax_steps.build_train_step(jax_get_model(jcfg), None,
                                       jax_steps.TrainStepConfig())
    jp, _, jm = jax.jit(jstep)(params, jax_steps.opt_state_for(params),
                               batch)
    step = steps.build_train_step(get_model(tcfg, "cpu"))
    out, opt, m = step(model, steps.opt_state_for(model), _torch(batch))
    assert out is model and int(opt.step) == 1
    assert not any(p.requires_grad for p in model.parameters())
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4, atol=1e-4)
    want = _flat(_np_tree(jp))
    for k, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[k], rtol=2e-2, atol=2e-4,
                                   err_msg=k)
    for k in XATTN_BIASES:
        assert not want[k].any() and not model.state_dict()[k].any(), k


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_input_specs_follow_the_reference(kind):
    jcfg, tcfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    api, japi = get_model(tcfg, "cpu"), jax_get_model(jcfg)
    shape = ShapeSpec("s", 160, 4, kind)

    def described(specs):
        return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in specs.items()}

    for mine, theirs in ((api.input_specs, japi.input_specs),
                         (api.decode_input_specs,
                          japi.decode_input_specs)):
        specs = mine(shape)
        assert described(specs) == described(theirs(shape))
        assert all(v.device.type == "meta" for v in specs.values())
    assert described(api.input_specs(shape))["tokens"] == ((4, 40), "int32")
    batch = api.input_specs(shape, abstract=False)
    assert batch["audio_feats"].dtype == torch.float32
    assert ("labels" in batch) == (kind == "train")
    lm = get_model(get_config("tinyllama-1.1b").reduced(), "cpu")
    assert described(lm.decode_input_specs(shape)) == described(
        jax_get_model(jax_config("tinyllama-1.1b").reduced())
        .decode_input_specs(shape))


def test_params_from_jax_round_trip():
    """The reference's tree loads ``strict`` into a ``WhisperModel`` and
    comes back key for key, value for value."""
    _, tcfg, params, model = _models()
    assert isinstance(model, whisper.WhisperModel)
    want = _flat(_np_tree(params))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.array_equal(v.numpy(), want[k]), k
    missing = dict(_np_tree(params))
    missing.pop("enc_norm")
    with pytest.raises(RuntimeError, match="enc_norm"):
        params_from_jax(missing, tcfg, "cpu")


# ------------------------------------------------------ under TENSILE
def test_captured_whisper_step_runs_bit_identical_under_a_tensile_plan():
    """``capture_train_step`` of reduced whisper's functional step (no
    remat; the unused cross-attention biases get zero gradients in the
    graph), planned by ``tensile`` at 0.7 of its planned peak: the
    executor's outputs equal the unscheduled step's bit for bit, and
    match the eager functional step."""
    cfg = get_config(ARCH).reduced(remat="none")
    api = get_model(cfg, "cpu")
    params = dict(api.init(torch.Generator().manual_seed(0))
                  .named_parameters())
    batch = api.input_specs(ShapeSpec("s", 160, 2, "train"), abstract=False)
    args = (params, adam.adamw_init(params), batch)
    fstep = steps.build_functional_train_step(api)
    seq, gm = tc.capture_train_step(fstep, *args)
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
    new_params, _, metrics = fstep(*args)
    keys = list(params)
    for k in XATTN_BIASES:
        assert not out[keys.index(k)].any()
    for i, k in enumerate(keys):
        np.testing.assert_allclose(out[i].numpy(), new_params[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ------------------------------------------------ data and the launcher
def test_token_stream_matches_reference_for_whisper():
    cfg = get_config(ARCH).reduced()
    kw = dict(seq_len=64, global_batch=4, vocab_size=cfg.vocab_size,
              frontend=cfg.frontend, d_model=cfg.d_model, enc_dec=True,
              seed=3)
    mine = pipeline.TokenStream(pipeline.DataConfig(**kw))
    theirs = jax_pipeline.TokenStream(jax_pipeline.DataConfig(**kw))
    for step in (0, 5):
        got, want = mine.batch_at(step), theirs.batch_at(step)
        assert set(got) == set(want) == {"audio_feats", "tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k
    assert got["audio_feats"].shape == (4, 64, cfg.d_model)
    assert got["tokens"].shape == (4, 16)


@pytest.mark.parametrize("budget_mb", ["0", "1"])
def test_launcher_trains_whisper(budget_mb, tmp_path, capsys):
    """``launch.train.main --arch whisper-base`` on the CPU, reduced, with
    and without TENSILE's planning of the captured step (whose decisions
    whisper's loss takes and ignores, as the reference's does)."""
    rc = train.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                     "--batch", "2", "--seq", "64",
                     "--tensile-budget-mb", budget_mb,
                     "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "arch=whisper-base-reduced" in out and "restarts=0" in out
    assert ("[tensile] remat=" in out) == (budget_mb != "0")


def test_whisper_reduced_config_is_what_the_tests_assume():
    cfg = get_config(ARCH).reduced()
    assert (cfg.n_enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.attn_chunk, cfg.dtype) == (
        2, 1, 128, 4, 2, 32, 64, "float32")
    assert cfg.qkv_bias and cfg.enc_dec and cfg.mlp_act == "gelu"
