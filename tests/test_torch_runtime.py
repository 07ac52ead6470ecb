"""The port's training runtime against the JAX package's, on the CPU: the
token stream and its prefetch (``data.pipeline``), checkpoints
(``checkpoint.manager``), the restart loop (``runtime.fault_tolerance``)
and the straggler monitor (``runtime.stragglers``).

Batches are numpy from the stream's own seeds and compare bit for bit;
the straggler monitor is the same Python on the same recorded times.  The
restart loop runs a reduced TinyLlama (fp32, weights drawn by the JAX
package) in both packages on the same batches and must give the same
restarts and final step, and the losses within the train-step tolerance
(``tests/test_torch_forward.py``: rtol 1e-4).  A checkpoint gives back
every leaf bit for bit, bf16 included.

One departure is held here: the reference's stream iterator yields the
batch after the loaded step once ``load_state_dict`` has run, so a
restart replays one batch late; the port's yields the loaded step's, and
its ``Prefetcher`` drops what it prefetched (``seek``).  A run that fails
and restarts ends with the state of the run that did not, bit for bit.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import pipeline as ref_data
from repro.launch import steps as jax_steps
from repro.models import transformer as jax_tf
from repro.models.registry import get_model as jax_get_model
from repro.runtime import fault_tolerance as ref_ft
from repro.runtime import stragglers as ref_strag
from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import pipeline
from repro_torch.launch import steps
from repro_torch.models.registry import get_model
from repro_torch.runtime import fault_tolerance, stragglers

ARCH = "tinyllama-1.1b"


def _cfg(**kw):
    base = dict(seq_len=16, global_batch=4, vocab_size=97, seed=3)
    base.update(kw)
    return ref_data.DataConfig(**base), pipeline.DataConfig(**base)


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


# ------------------------------------------------------------ data
@pytest.mark.parametrize("host,n_hosts", [(0, 1), (0, 2), (1, 2)])
def test_token_stream_matches_reference(host, n_hosts):
    jc, tc = _cfg()
    ref = ref_data.TokenStream(jc, host, n_hosts)
    got = pipeline.TokenStream(tc, host, n_hosts)
    for step in range(4):
        assert _same(got.batch_at(step), ref.batch_at(step))
    it_r, it_t = iter(ref), iter(got)
    for _ in range(3):
        assert _same(next(it_t), next(it_r))
    assert got.state_dict()["seed"] == ref.state_dict()["seed"]


def test_token_stream_resumes_at_the_loaded_step():
    """After ``load_state_dict({"step": 1})`` the port's iterator yields
    batch 1; the reference's yields batch 2 (its generator advances the
    step after it resumes)."""
    jc, tc = _cfg()
    ref, got = ref_data.TokenStream(jc), pipeline.TokenStream(tc)
    it_r, it_t = iter(ref), iter(got)
    for _ in range(3):
        next(it_r), next(it_t)
    ref.load_state_dict({"step": 1})
    got.load_state_dict({"step": 1})
    assert _same(next(it_t), got.batch_at(1))
    assert _same(next(it_r), ref.batch_at(2))
    assert _same(next(it_t), ref.batch_at(2))


def test_prefetcher_yields_the_stream_in_order_and_seeks():
    _, tc = _cfg()
    stream = pipeline.TokenStream(tc)
    pf = pipeline.Prefetcher(stream, to_device=pipeline.to_device("cpu"))
    try:
        first = [next(pf) for _ in range(5)]
        for step, b in enumerate(first):
            assert all(isinstance(v, torch.Tensor) for v in b.values())
            assert _same({k: v.numpy() for k, v in b.items()},
                         stream.batch_at(step))
        pf.seek({"step": 2, "seed": tc.seed, "host_id": 0})
        again = next(pf)
        assert np.array_equal(again["tokens"].numpy(),
                              stream.batch_at(2)["tokens"])
    finally:
        pf.close()


# ------------------------------------------------------------ checkpoints
def _state(seed: int = 0):
    rng = np.random.default_rng(seed)
    bf16 = torch.from_numpy(rng.integers(-2**15, 2**15, (5, 7),
                                         dtype=np.int16)).view(torch.bfloat16)
    return {"w": bf16, "m": [torch.from_numpy(rng.standard_normal(
        (3, 4), dtype=np.float32)), torch.tensor(7, dtype=torch.int32)]}


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    """bf16 leaves as raw words (NaN payloads too) and the dtypes in
    ``meta.json``; a restore into the live state writes its tensors."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = _state()
    mgr.save(4, state, {"data_state": {"step": 5}})
    leaves, meta = mgr.restore()
    assert meta["step"] == 4 and meta["data_state"] == {"step": 5}
    assert meta["dtypes"] == ["bfloat16", "float32", "int32"]
    want = [state["w"], *state["m"]]
    assert all(a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
               for a, b in zip(leaves, want))
    live = _state(seed=1)
    held = live["m"][0]
    out, _ = mgr.restore(4, template=live)
    assert out is live and live["m"][0] is held
    assert all(np.array_equal(_bits(a), _bits(b))
               for a, b in zip([live["w"], *live["m"]], want))


def test_a_module_is_saved_by_its_parameter_names(tmp_path):
    tcfg = get_config(ARCH).reduced(n_layers=1)
    model = get_model(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    opt = steps.opt_state_for(model)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, (model, opt))
    with open(os.path.join(mgr._step_dir(0), "meta.json")) as f:
        paths = json.load(f)["paths"]
    names = [n for n, _ in model.named_parameters()]
    assert paths[:len(names)] == [f"[0]/{n}" for n in names]
    other = get_model(tcfg, "cpu").init(torch.Generator().manual_seed(1))
    mgr.restore(0, template=(other, steps.opt_state_for(other)))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 other.parameters()))


def test_a_directory_without_commit_is_ignored_and_keep_collects(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in range(4):
        mgr.save(step, _state(step))
    os.makedirs(mgr._step_dir(9))            # a save that crashed
    assert mgr.latest_step() == 3
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_000000002", "step_000000003", "step_000000009"]
    leaves, _ = mgr.restore()
    assert np.array_equal(_bits(leaves[0]), _bits(_state(3)["w"]))


def test_save_async_is_isolated_from_an_update_right_after(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    want = [t.clone() for t in (state["w"], *state["m"])]
    mgr.save_async(1, state)
    for t in (state["w"], *state["m"]):
        t.add_(1)                            # the next step, in place
    mgr.wait()
    leaves, _ = mgr.restore(1)
    assert all(np.array_equal(_bits(a), _bits(b))
               for a, b in zip(leaves, want))


def test_a_checkpoint_without_zstandard_restores(tmp_path, monkeypatch):
    monkeypatch.setattr(manager, "_zstd", None)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, _state())
    assert os.listdir(mgr._step_dir(2)).count("shard_00000.npz") == 1
    monkeypatch.undo()
    leaves, _ = mgr.restore(2)
    assert np.array_equal(_bits(leaves[0]), _bits(_state()["w"]))


# ------------------------------------------------------------ restart loop
def _lm():
    jcfg = jax_config(ARCH).reduced(n_layers=2)
    tcfg = get_config(ARCH).reduced(n_layers=2)
    params, _ = jax_tf.init_model(jcfg, jax.random.PRNGKey(1))
    return jcfg, tcfg, params


def _batches(vocab: int, n: int):
    stream = pipeline.TokenStream(pipeline.DataConfig(
        seq_len=16, global_batch=2, vocab_size=vocab, seed=5))
    return [stream.batch_at(s) for s in range(n)]


def test_resilient_loop_matches_reference(tmp_path):
    """Five steps, a checkpoint every two, one injected failure at step
    3: both loops restart once from step 2 and take the same batches."""
    jcfg, tcfg, params = _lm()
    data = _batches(tcfg.vocab_size, 8)
    kw = dict(n_steps=5, fail_at={3: 1})
    jstep = jax.jit(jax_steps.build_train_step(jax_get_model(jcfg), None))
    want = ref_ft.resilient_train_loop(
        jstep, (params, jax_steps.opt_state_for(params)), iter(data),
        ft=ref_ft.FTConfig(ckpt_dir=str(tmp_path / "ref"), ckpt_every=2),
        **kw)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    got = fault_tolerance.resilient_train_loop(
        steps.build_train_step(get_model(tcfg, "cpu")),
        (model, steps.opt_state_for(model)),
        ({k: torch.from_numpy(v) for k, v in b.items()} for b in data),
        ft=fault_tolerance.FTConfig(ckpt_dir=str(tmp_path / "port"),
                                    ckpt_every=2), **kw)
    assert (got.final_step, got.restarts, got.preempted) \
        == (want.final_step, want.restarts, want.preempted) == (4, 1, False)
    assert len(got.metrics_history) == len(want.metrics_history) == 5
    for g, w in zip(got.metrics_history, want.metrics_history):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
    assert CheckpointManager(str(tmp_path / "port")).latest_step() == 4


def _run(tcfg, params, ckpt_dir: str, fail_at=None):
    """Six steps from the stream through the prefetcher, a checkpoint at
    step 3: the final state's leaves and the loop's result."""
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    opt = steps.opt_state_for(model)
    stream = pipeline.TokenStream(pipeline.DataConfig(
        seq_len=16, global_batch=2, vocab_size=tcfg.vocab_size, seed=5))
    pf = pipeline.Prefetcher(stream, to_device=pipeline.to_device("cpu"))
    try:
        res = fault_tolerance.resilient_train_loop(
            steps.build_train_step(get_model(tcfg, "cpu")), (model, opt), pf,
            6, ft=fault_tolerance.FTConfig(ckpt_dir=ckpt_dir, ckpt_every=3,
                                           keep=1),
            data_stream=stream, fail_at=fail_at)
    finally:
        pf.close()
    return [t.clone() for t in (*model.parameters(), *opt.mu.values(),
                                *opt.nu.values())], res


def test_a_restart_resumes_the_data_and_ends_as_an_unbroken_run(tmp_path):
    torch.use_deterministic_algorithms(True)
    try:
        _, tcfg, params = _lm()
        want, _ = _run(tcfg, params, str(tmp_path / "a"))
        got, res = _run(tcfg, params, str(tmp_path / "b"), fail_at={4: 1})
    finally:
        torch.use_deterministic_algorithms(False)
    assert res.restarts == 1 and res.final_step == 5
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------------ stragglers
def test_straggler_monitor_matches_reference():
    times = np.random.default_rng(0).uniform(0.9, 1.1, (12, 4))
    times[:, 2] *= 3.0                       # host 2 is slow throughout
    cfg = dict(window=8, z_threshold=3.0, evict_after=3, min_samples=3)
    ref = ref_strag.StragglerMonitor(4, ref_strag.StragglerConfig(**cfg))
    got = stragglers.StragglerMonitor(4, stragglers.StragglerConfig(**cfg))
    for step, row in enumerate(times):
        for host, t in enumerate(row):
            ref.record(host, step, float(t))
            got.record(host, step, float(t))
        assert got.stragglers() == ref.stragglers()
        assert got.should_evict() == ref.should_evict()
    shards = {h: 4 for h in range(4)}
    assert got.rebalance(shards) == ref.rebalance(shards)
    assert got.should_evict() == [2]
