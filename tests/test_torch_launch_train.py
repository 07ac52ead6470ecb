"""The port's training launcher (``launch.train.main``,
``examples/train_lm_torch.py``) and the train-step options it uses
(``launch.steps``: int8 error-feedback gradients, moments on the host,
fp32 master weights) against the JAX package's, on the CPU.

The train step is held to the reference's step on the same state and
batch (reduced TinyLlama, fp32, weights drawn by the JAX package) at the
port's train-step tolerances (``tests/test_torch_forward.py``: loss rtol
1e-4; parameters rtol 2e-2, atol 2e-4).  Moments kept on the host move
between devices, never through other arithmetic, so that step is the
plain one bit for bit (on the CPU, where nothing moves; on a card:
``tests/test_torch_cuda_training.py``).  The launcher runs end to end on
the CPU at a reduced size, and no CPU tensor reaches a kernel's CUDA
branch.
"""
import os
import re
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import steps as jax_steps
from repro.models import transformer as jax_tf
from repro.models.registry import get_model as jax_get_model
from repro.optim import adam as jax_adam
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention, kv_block_copy, offload_quant
from repro_torch.kernels import ssd_scan
from repro_torch.launch import steps, train
from repro_torch.models.registry import get_model
from repro_torch.optim import adam

ARCH = "tinyllama-1.1b"
ROOT = os.path.join(os.path.dirname(__file__), "..")
KERNELS = (flash_attention.flash_attention_fwd, kv_block_copy.kv_block_gather,
           kv_block_copy.kv_block_scatter, offload_quant.quantize_blocked,
           offload_quant.dequantize_blocked, ssd_scan.ssd_intra_chunk_fwd)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _setup(n_layers: int = 2):
    jcfg = jax_config(ARCH).reduced(n_layers=n_layers)
    tcfg = get_config(ARCH).reduced(n_layers=n_layers)
    params, _ = jax_tf.init_model(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, tcfg.vocab_size, (4, 32), dtype=np.int32)
             for k in ("tokens", "labels")}
    return jcfg, tcfg, params, batch


def _model(params, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")


def _close_to(got: dict, want, rtol=2e-2, atol=2e-4):
    want = _flat(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    for k, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("steps_n", [1, 3])
def test_int8_compressed_step_matches_reference(steps_n):
    """``grad_compression="int8"`` from a state with an ``ef`` residual,
    for one step and for three (the residual carried)."""
    jcfg, tcfg, params, batch = _setup()
    jstep = jax.jit(jax_steps.build_train_step(
        jax_get_model(jcfg), None,
        jax_steps.TrainStepConfig(grad_compression="int8")))
    jopt = jax_adam.adamw_init(params, grad_compression=True)
    model = _model(params, tcfg)
    opt = adam.adamw_init(dict(model.named_parameters()),
                          grad_compression=True)
    step = steps.build_train_step(get_model(tcfg, "cpu"),
                                  steps.TrainStepConfig(
                                      grad_compression="int8"))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(steps_n):
        params, jopt, jm = jstep(params, jopt, batch)
        _, opt, m = step(model, opt, tbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    _close_to(dict(model.named_parameters()), params)
    assert int(opt.step) == steps_n
    assert all(torch.isfinite(t).all() and t.abs().max() > 0
               for t in opt.ef.values())


def test_master_weights_step_matches_reference():
    """``use_master``: the state ``opt_state_for(params, use_master=True)``
    makes carries fp32 masters that the step updates as the
    reference's ``adamw_init(use_master=True)`` state."""
    jcfg, tcfg, params, batch = _setup()
    jstep = jax.jit(jax_steps.build_train_step(
        jax_get_model(jcfg), None,
        jax_steps.TrainStepConfig(use_master=True)))
    jp, jopt, _ = jstep(params, jax_steps.opt_state_for(
        params, use_master=True), batch)
    model = _model(params, tcfg)
    tcfg_s = steps.TrainStepConfig(use_master=True)
    opt = steps.opt_state_for(model, use_master=tcfg_s.use_master)
    _, opt, _ = steps.build_train_step(get_model(tcfg, "cpu"), tcfg_s)(
        model, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close_to(dict(model.named_parameters()), jp)
    _close_to(opt.master, jopt.master)
    assert all(t.dtype == torch.float32 for t in opt.master.values())


def _two_steps(tcfg, params, batch, **kw):
    model = _model(params, tcfg)
    opt = steps.opt_state_for(model, use_master=True)
    step = steps.build_train_step(get_model(tcfg, "cpu"),
                                  steps.TrainStepConfig(**kw))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(2):
        _, opt, m = step(model, opt, tbatch)
    return [*model.parameters(), *opt.mu.values(), *opt.nu.values(),
            *opt.master.values()], m, opt


def test_offloaded_opt_state_step_is_the_plain_step_on_the_cpu():
    _, tcfg, params, batch = _setup()
    got, m, opt = _two_steps(tcfg, params, batch, offload_opt_state=True)
    want, mw, _ = _two_steps(tcfg, params, batch)
    assert torch.equal(m["loss"], mw["loss"])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert steps.offloaded_bytes(opt) == 3 * sum(
        t.numel() * 4 for t in opt.mu.values())


def test_a_fetched_moment_updated_in_its_own_memory_is_the_same():
    """Moments fetched from the host are updated in the fetched copies
    (no second copy on the card): the same operations, the same bits."""
    rng = np.random.default_rng(4)
    p, g, m, v = (torch.from_numpy(rng.standard_normal(
        (64, 33), dtype=np.float32)) for _ in range(4))
    v = v.abs()
    kw = dict(scale=torch.tensor(0.5), bc1=torch.tensor(0.19),
              bc2=torch.tensor(0.002), lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
              weight_decay=0.01)
    want = adam._leaf(p, g.bfloat16(), m, v, None, **kw)
    mc, vc = m.clone(), v.clone()
    got = adam._leaf(p, g.bfloat16(), mc, vc, None, scratch=True, **kw)
    assert got[1] is mc and got[2] is vc
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------------ the launcher
def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    """The reference's flags plus ``--device``: TENSILE's decisions under
    a budget, int8 gradients, checkpoints; finite loss, return 0, and no
    kernel's CUDA branch reached (the train step uses ``attend_full``)."""
    before = [k.launches for k in KERNELS]
    rc = train.main(["--arch", ARCH, "--steps", "4", "--batch", "2",
                     "--seq", "32", "--tensile-budget-mb", "1",
                     "--grad-compression", "int8", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                     "--log-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[tensile] remat=" in out and "restarts=0" in out
    first, last = map(float, re.search(
        r"loss (\S+) -> (\S+)", out).groups())
    assert np.isfinite(first) and np.isfinite(last)
    assert [k.launches for k in KERNELS] == before
    assert sorted(os.listdir(tmp_path)) == ["step_000000002",
                                            "step_000000003"]


def test_launcher_resumes_from_its_checkpoints(tmp_path, capsys):
    """A second run over the same directory starts after its last
    committed step."""
    args = ["--steps", "3", "--batch", "2", "--seq", "16", "--device",
            "cpu", "--ckpt-dir", str(tmp_path), "--log-every", "1"]
    assert train.main(args) == 0
    capsys.readouterr()
    assert train.main(args[:1] + ["5"] + args[2:]) == 0
    out = capsys.readouterr().out
    assert "steps=5" in out and out.count("  step ") == 2


def test_example_runs_the_launcher(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "train_lm_torch.py", "--steps", "2", "--batch", "2", "--seq", "16",
        "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit) as ei:
        runpy.run_path(os.path.join(ROOT, "examples", "train_lm_torch.py"),
                       run_name="__main__")
    assert ei.value.code == 0


def test_launcher_needs_the_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
