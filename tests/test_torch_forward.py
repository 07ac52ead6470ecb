"""The port's LM forward, loss, optimizer and train step against the JAX
package's, on reduced TinyLlama (fp32) on the CPU.

Weights are drawn by the JAX package and moved across as numpy through
``params_from_jax``; activations, tokens and labels come from numpy with a
fixed seed and go to both.  Tolerances, fp32 throughout:

* attention paths 1e-5: one attention layer, summed in different orders
  (XLA's CPU kernels against PyTorch's), a few ulps;
* forward logits and losses rtol = atol = 1e-4, as
  ``test_torch_model.py`` holds the decode step: the order differences
  grow by a few ulps per layer;
* gradients rtol = 1e-4, atol = 1e-6: sums over every token of the batch;
* ``adamw_update`` from identical grads and state 1e-6: the same
  elementwise fp32 arithmetic, up to fused multiply-adds;
* a train step against the reference's rtol 2e-2, atol 2e-4 on the new
  parameters (``tests/test_launch.py:119-121``): Adam's first step moves
  each weight by about the learning rate times the gradient's sign, so a
  gradient within rounding of 0 may move either way on either side;
* the forward against the port's own decode 2e-3
  (``tests/test_models.py:108-125``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import steps as jax_steps
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tf
from repro.models.registry import get_model as jax_get_model
from repro.optim import adam as jax_adam
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import adam_state_from_jax, params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import steps
from repro_torch.models import attention, transformer
from repro_torch.models.registry import get_model
from repro_torch.optim import adam

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
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _models(n_layers=1, seed=1, **overrides):
    jcfg, tcfg = _cfgs(n_layers=n_layers, **overrides)
    params, _ = jax_tf.init_model(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, params, params_from_jax(_np_tree(params), tcfg, "cpu")


def _batch(vocab, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s), dtype=np.int32),
            "labels": rng.integers(0, vocab, (b, s), dtype=np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(api, model, batch):
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    try:
        loss = api.loss(model, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
    finally:
        for p in named.values():
            p.requires_grad_(False)
    return loss.detach(), dict(zip(named, grads))


def _qkv(b, sq, skv, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, kvh, d), dtype=np.float32),
            rng.standard_normal((b, skv, kvh, d), dtype=np.float32))


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 8)])
def test_attend_full_matches_reference(causal, window):
    arrays = _qkv(2, 40, 40, 4, 2, 32)
    want = jax_attn.attend_full(*map(jnp.asarray, arrays), causal=causal,
                                sliding_window=window)
    got = attention.attend_full(*map(torch.from_numpy, arrays),
                                causal=causal, sliding_window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48)])
def test_attend_chunked_matches_reference(causal, window):
    """S = 160 with chunk 64: three Q and KV chunks, the last one padded."""
    arrays = _qkv(2, 160, 160, 4, 2, 32)
    want = jax_attn.attend_chunked(*map(jnp.asarray, arrays), causal=causal,
                                   chunk=64, sliding_window=window)
    got = attention.attend_chunked(*map(torch.from_numpy, arrays),
                                   causal=causal, chunk=64,
                                   sliding_window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_attend_chunked_gradients_match_reference():
    """Through the checkpointed KV steps: the gradients of a weighted sum
    of the output against ``jax.grad`` of the reference's scan."""
    arrays = _qkv(1, 160, 160, 4, 2, 32)
    w = np.random.default_rng(2).standard_normal((1, 160, 4, 32),
                                                 dtype=np.float32)

    def jloss(q, k, v):
        return jnp.sum(jax_attn.attend_chunked(q, k, v, causal=True,
                                               chunk=64) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    out = attention.attend_chunked(q, k, v, causal=True, chunk=64)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (q, k, v))
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("flash,seq", [(False, 96), (False, 160),
                                       (True, 96), (True, 160)])
def test_attention_block_matches_reference(flash, seq):
    """``attend_full`` (S <= 2 * attn_chunk), ``attend_chunked`` (S = 160)
    and the flash path (the Pallas kernel in interpret mode against the
    port's wrapper, which takes its plain version on the CPU)."""
    jcfg, tcfg, params, model = _models()
    jcfg = dataclasses.replace(jcfg, use_flash_kernel=flash)
    tcfg = dataclasses.replace(tcfg, use_flash_kernel=flash)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, seq, jcfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (2, seq))
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["layer0"]["attn"])
    want = jax_attn.attention_block(jp, jnp.asarray(x), jnp.asarray(pos),
                                    cfg=jcfg)
    n0 = fa.flash_attention_fwd.launches
    with torch.inference_mode():
        got = attention.attention_block(
            model["blocks"]["layer0"].at(0)["attn"], torch.from_numpy(x),
            torch.from_numpy(pos.copy()), cfg=tcfg)
    assert fa.flash_attention_fwd.launches == n0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------- forward / loss
@pytest.mark.parametrize("n_layers", [1, 3])
def test_forward_matches_reference(n_layers):
    jcfg, tcfg, params, model = _models(n_layers)
    batch = _batch(tcfg.vocab_size)
    want, _ = jax_tf.forward(params, batch["tokens"], jcfg)
    api = get_model(tcfg, "cpu")
    got = steps.build_prefill_step(api)(model, _torch(batch))
    assert got.shape == (2, 24, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("loss_chunk", [0, 16])
def test_loss_matches_reference(loss_chunk):
    """``loss_chunk`` 16 runs the fused LM head + CE over two chunks of a
    24-token sequence, the second padded with masked labels."""
    jcfg, tcfg, params, model = _models(2, loss_chunk=loss_chunk)
    batch = _batch(tcfg.vocab_size)
    batch["labels"][0, :5] = -1                         # masked tokens
    want = jax_tf.loss_fn(params, batch, jcfg)
    with torch.no_grad():
        got = get_model(tcfg, "cpu").loss(model, _torch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("loss_chunk", [0, 16])
def test_gradients_match_reference(loss_chunk):
    jcfg, tcfg, params, model = _models(2, loss_chunk=loss_chunk)
    batch = _batch(tcfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_tf.loss_fn(p, batch, jcfg))(params)
    loss, grads = _port_grads(get_model(tcfg, "cpu"), model, _torch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                               atol=1e-4)
    want = _flat(jgrads)
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_block_remat_gives_the_same_gradients():
    """Checkpointing each repeat recomputes the same ops on the same
    inputs, so the gradients are equal bit for bit."""
    _, tcfg, _, model = _models(3)
    batch = _torch(_batch(tcfg.vocab_size))
    on = _port_grads(get_model(dataclasses.replace(tcfg, remat="block"),
                               "cpu"), model, batch)
    off = _port_grads(get_model(dataclasses.replace(tcfg, remat="none"),
                                "cpu"), model, batch)
    assert torch.equal(on[0], off[0])
    for k in on[1]:
        assert torch.equal(on[1][k], off[1][k]), k


def test_forward_matches_own_decode():
    """The parallel forward over a prompt gives the logits of one-token
    decode steps over the same prompt (KV-cache correctness)."""
    _, tcfg, _, model = _models()
    api = get_model(tcfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 100, (2, 12), dtype=np.int32))
    with torch.inference_mode():
        par, _ = api.forward(model, {"tokens": toks})
        cache = api.init_cache(2, 16)
        outs = []
        for i in range(12):
            lg, cache = api.decode(model, {"tokens": toks[:, i:i + 1]},
                                   cache, i)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(par.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)


def test_input_specs_follow_the_reference():
    jcfg, tcfg = _cfgs()
    api, japi = get_model(tcfg, "cpu"), jax_get_model(jcfg)
    for kind in ("train", "prefill"):
        shape = ShapeSpec("s", 32, 4, kind)
        specs, want = api.input_specs(shape), japi.input_specs(shape)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in specs.items()} \
            == {k: (v.shape, str(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in specs.values())
    batch = api.input_specs(ShapeSpec("s", 32, 4, "train"), abstract=False)
    again = api.input_specs(ShapeSpec("s", 32, 4, "train"), abstract=False)
    assert torch.equal(batch["tokens"], again["tokens"])
    assert int(batch["tokens"].max()) < 32 and batch["tokens"].dtype \
        == torch.int32


# ------------------------------------------------------------ optimizer
def _random_tree(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: rng.standard_normal(
        p.shape, dtype=np.float32).astype(p.dtype) * 1e-2, params)


@pytest.mark.parametrize("use_master", [False, True])
def test_adamw_update_matches_reference(use_master):
    """Two reference steps give a state past step 1 (non-zero moments,
    bias correction below 1); the port continues from it with the same
    grads and clipping as the reference."""
    _, _, params, model = _models(2)
    state = jax_adam.adamw_init(params, use_master=use_master)
    kw = dict(lr=1e-3, weight_decay=0.01, grad_clip_norm=0.5)
    for seed in (0, 1):
        params, state = jax_adam.adamw_update(
            params, _random_tree(params, seed), state, **kw)
    grads = _random_tree(params, 2)
    want_p, want_s = jax_adam.adamw_update(params, grads, state, **kw)

    model = params_from_jax(_np_tree(params), get_config(ARCH).reduced(
        n_layers=2), "cpu")
    tstate = adam_state_from_jax(_np_tree(state), model)
    assert int(tstate.step) == 2
    named = dict(model.named_parameters())
    tgrads = {k: torch.from_numpy(v) for k, v in _flat(grads).items()}
    _, new = adam.adamw_update(named, tgrads, tstate, **kw)
    assert int(new.step) == 3
    for got, want in ((named, want_p), (new.mu, want_s.mu),
                      (new.nu, want_s.nu)) + (
                          ((new.master, want_s.master),) if use_master
                          else ()):
        want = _flat(want)
        for k, t in got.items():
            np.testing.assert_allclose(t.numpy(), want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_global_norm_and_sgd_match_reference():
    _, _, params, model = _models()
    grads = _random_tree(params, 0)
    tgrads = {k: torch.from_numpy(v) for k, v in _flat(grads).items()}
    np.testing.assert_allclose(float(adam.global_norm(tgrads)),
                               float(jax_adam.global_norm(grads)),
                               rtol=1e-6)
    want = _flat(jax_adam.sgd_update(params, grads, 0.1))
    named = dict(model.named_parameters())
    adam.sgd_update(named, tgrads, 0.1)
    for k, t in named.items():
        np.testing.assert_allclose(t.numpy(), want[k], rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------- train step
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    jcfg, tcfg, params, model = _models(2)
    batch = _batch(tcfg.vocab_size, b=4, s=32)
    jstep = jax_steps.build_train_step(
        jax_get_model(jcfg), None,
        jax_steps.TrainStepConfig(microbatches=microbatches))
    jp, jopt, jm = jax.jit(jstep)(params, jax_steps.opt_state_for(params),
                                  batch)
    step = steps.build_train_step(
        get_model(tcfg, "cpu"),
        steps.TrainStepConfig(microbatches=microbatches))
    out, opt, m = step(model, steps.opt_state_for(model), _torch(batch))
    assert out is model and int(opt.step) == 1
    assert not any(p.requires_grad for p in model.parameters())
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    want = _flat(_np_tree(jp))
    for k, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[k], rtol=2e-2, atol=2e-4,
                                   err_msg=k)
    want_mu = _flat(_np_tree(jopt.mu))
    for k, t in opt.mu.items():
        np.testing.assert_allclose(t.numpy(), want_mu[k], rtol=1e-3,
                                   atol=1e-7, err_msg=k)


def test_microbatched_step_matches_full_batch():
    """The port's own accumulation: two halves give the full batch's loss
    and, within the reference test's tolerance, its parameters."""
    _, tcfg, params, _ = _models(2)
    batch = _torch(_batch(tcfg.vocab_size, b=4, s=32))
    out = []
    for n in (1, 2):
        model = params_from_jax(_np_tree(params), tcfg, "cpu")
        step = steps.build_train_step(get_model(tcfg, "cpu"),
                                      steps.TrainStepConfig(microbatches=n))
        _, _, m = step(model, steps.opt_state_for(model), batch)
        out.append((float(m["loss"]), model.state_dict()))
    assert abs(out[0][0] - out[1][0]) < 1e-5
    for k, t in out[0][1].items():
        np.testing.assert_allclose(t.numpy(), out[1][1][k].numpy(),
                                   rtol=2e-2, atol=2e-4, err_msg=k)


def test_unported_options_raise():
    _, tcfg = _cfgs()
    api = get_model(tcfg, "cpu")
    with pytest.raises(NotImplementedError, match="training slice"):
        steps.build_train_step(api, steps.TrainStepConfig(
            grad_compression="int8"))
    with pytest.raises(NotImplementedError, match="training slice"):
        steps.build_train_step(api, steps.TrainStepConfig(
            remat_policy=lambda *a: True))
    model = api.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="training slice"):
        transformer.forward(model, torch.zeros((1, 4), dtype=torch.int32),
                            tcfg, remat_policy=lambda *a: True)
    abstract = steps.opt_state_for(model, abstract=True)
    assert all(t.device.type == "meta" for t in abstract.mu.values())
