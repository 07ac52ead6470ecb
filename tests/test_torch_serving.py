"""The port's serving plane against the JAX package's, on the CPU.

* The virtual ``ServeSession`` (a copy) makes the reference's decisions:
  same decision trace, peak, evictions and virtual time.
* ``ServingEngine(device="cpu")`` on reduced TinyLlama (fp32), with the
  JAX engine's weights and prompts, produces the JAX engine's tokens,
  decision trace and report, on the per-slot and the batched data path.
* The port's run under a half-size KV budget is bit-identical to its
  unbudgeted run, and the batched run moves cohorts through the CPU path
  of the gather/scatter wrappers.

Tokens are compared exactly: greedy argmax over logits that agree to
about 1e-6 (see test_torch_model.py) flips only on a near-tie, which these
seeded weights do not have.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import MachineProfile as JaxProfile
from repro.core import MemoryEngine as JaxMemoryEngine
from repro.serving import ServeSession as JaxServeSession
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import make_trace as jax_make_trace
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import MachineProfile, MemoryEngine
from repro_torch.kernels import kv_block_copy as kbc
from repro_torch.serving import ServeSession, ServingEngine, make_trace
from repro_torch.serving import engine as serving_engine

BPT = 512
PROMPT, GEN = 4, 8
MAX_LEN = PROMPT + GEN
BUDGET = BPT * (MAX_LEN * 2 + 2)      # about 2 of 4 slots resident
JAX_PROFILE = dict(host_link_bw=16e9, compute_flops=5e10, mem_bw=1e10)
# the port's defaults describe the H100; pass the reference's link values
PORT_PROFILE = dict(host_link_bw=16e9, host_link_latency=15e-6,
                    dma_batch_overhead=2e-6, compute_flops=5e10, mem_bw=1e10)


def _mem(port: bool, budget=BUDGET):
    if port:
        return MemoryEngine(MachineProfile(**PORT_PROFILE),
                            capacity_bytes=budget, trace=True)
    return JaxMemoryEngine(JaxProfile(**JAX_PROFILE), capacity_bytes=budget,
                           trace=True)


@pytest.fixture(scope="module")
def trace6():
    return make_trace("poisson", 6, seed=0, prompt_len=PROMPT, gen_len=GEN)


def _engine_pair(arch: str):
    jeng = JaxServingEngine(arch, max_sequences=4, max_len=MAX_LEN, seed=0)
    teng = ServingEngine(arch, max_sequences=4, max_len=MAX_LEN, seed=0,
                         device="cpu")
    teng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                  teng.cfg, "cpu")
    teng.prompt_for = jeng.prompt_for     # the reference's prompts, as-is
    return jeng, teng


@pytest.fixture(scope="module")
def engines():
    return _engine_pair("tinyllama-1.1b")


@pytest.fixture(scope="module")
def other_engines():
    """Engine pairs of the MoE and hybrid configs, made on first use."""
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = _engine_pair(arch)
        return made[arch]
    return get


def test_traces_are_copies(trace6):
    ref = jax_make_trace("poisson", 6, seed=0, prompt_len=PROMPT,
                         gen_len=GEN)
    assert [dataclasses.asdict(r) for r in trace6] \
        == [dataclasses.asdict(r) for r in ref]


@pytest.mark.parametrize("batch_transfers", [False, True])
def test_virtual_session_matches_the_reference(trace6, batch_transfers):
    kw = dict(max_sequences=4, bytes_per_token=BPT, block_tokens=4,
              budget_bytes=BUDGET, schedule=True,
              batch_transfers=batch_transfers)
    mem_j, mem_t = _mem(False), _mem(True)
    ref = JaxServeSession(trace6, engine=mem_j, **kw).run()
    got = ServeSession(trace6, engine=mem_t, **kw).run()
    assert mem_t.trace.keys() == mem_j.trace.keys()
    assert got.peak_bytes == ref.peak_bytes
    assert got.evictions == ref.evictions > 0
    assert got.total_time == pytest.approx(ref.total_time)


def test_engine_shapes_match_the_reference(engines):
    jeng, teng = engines
    assert teng.bytes_per_token == jeng.bytes_per_token == BPT
    assert [(a.batch, a.length) for a in teng._axes] \
        == [(a.batch, a.length) for a in jeng._axes]


@pytest.mark.parametrize("arch,batch_transfers", [
    pytest.param(None, False, id="False"),
    pytest.param(None, True, id="True"),
    # reduced MoE serves the dense path, as the reference's engine does
    pytest.param("moonshot-v1-16b-a3b", True, id="moonshot-v1-16b-a3b-True"),
    # 30 slotted cache leaves: two groups of at most MAX_LEAVES a transfer
    pytest.param("jamba-1.5-large-398b", True,
                 id="jamba-1.5-large-398b-True")])
def test_engine_matches_the_reference(engines, other_engines, trace6, arch,
                                      batch_transfers):
    jeng, teng = other_engines(arch) if arch else engines
    assert teng.bytes_per_token == jeng.bytes_per_token
    assert teng.cfg.moe_impl == jeng.cfg.moe_impl
    budget = teng.bytes_per_token * (MAX_LEN * 2 + 2)
    mem_j, mem_t = _mem(False, budget), _mem(True, budget)
    rep_j, out_j = jeng.serve(trace6, budget_bytes=budget, engine=mem_j,
                              batch_transfers=batch_transfers)
    rep_t, out_t = teng.serve(trace6, budget_bytes=budget, engine=mem_t,
                              batch_transfers=batch_transfers)
    assert out_t == out_j
    assert mem_t.trace.keys() == mem_j.trace.keys()
    assert dataclasses.asdict(rep_t) == dataclasses.asdict(rep_j)
    assert rep_t.evictions > 0 and rep_t.oom_events == 0


def test_swapped_run_is_bit_identical_to_the_unswapped_run(engines, trace6):
    _, teng = engines
    _, golden = teng.serve(trace6, budget_bytes=None, schedule=False)
    assert len(golden) == 6 and all(len(t) == GEN for t in golden.values())
    for batch_transfers in (False, True):
        rep, out = teng.serve(trace6, budget_bytes=BUDGET, engine=_mem(True),
                              batch_transfers=batch_transfers)
        assert rep.oom_events == 0 and rep.evictions > 0
        assert rep.peak_bytes <= BUDGET
        assert out == golden


def test_batched_run_takes_the_cpu_gather_scatter_path(engines, trace6,
                                                       monkeypatch):
    _, teng = engines
    seen = []

    def spy(fn, name):
        def call(leaves, idx, *rest, **kw):
            seen.append((name, {leaf.device.type for leaf in leaves},
                         len(idx), len(leaves)))
            return fn(leaves, idx, *rest, **kw)
        return call

    monkeypatch.setattr(serving_engine, "kv_block_gather",
                        spy(serving_engine.kv_block_gather, "gather"))
    monkeypatch.setattr(serving_engine, "kv_block_scatter",
                        spy(serving_engine.kv_block_scatter, "scatter"))
    launches = (kbc.kv_block_gather.launches, kbc.kv_block_scatter.launches)
    teng.serve(trace6, budget_bytes=BUDGET, engine=_mem(True),
               batch_transfers=True)
    assert {n for n, _, _, _ in seen} == {"gather", "scatter"}
    assert all(dev == {"cpu"} and k >= 2 for _, dev, k, _ in seen)
    # one call moves every cache leaf that holds a slot
    assert {n for _, _, _, n in seen} == {len(teng._slotted()[1])}
    # the CPU path is the plain version: no kernel launched, none counted
    assert (kbc.kv_block_gather.launches,
            kbc.kv_block_scatter.launches) == launches


def test_batched_transfers_move_the_cache_in_place(engines, trace6,
                                                   monkeypatch):
    """Every batched save and restore hands the kernels the cache's own
    leaves and reads and writes them in place (no leaf is copied whole, and
    no leaf's storage is replaced), and the served tokens are the reference
    engine's."""
    jeng, teng = engines
    ptrs = [leaf.data_ptr() for leaf in teng._leaves()]
    after = []
    for name in ("_save_slots", "_restore_slots"):
        def wrapped(states, fn=getattr(teng, name)):
            moved = fn(states)
            after.append([leaf.data_ptr() for leaf in teng._leaves()])
            return moved
        monkeypatch.setattr(teng, name, wrapped)
    calls = []

    def spy(fn):
        def call(leaves, idx, *rest, **kw):
            # the cache's own leaves, not copies of them
            cache = teng._leaves()
            assert all(any(leaf is c for c in cache) for leaf in leaves)
            calls.append(fn.__name__)
            return fn(leaves, idx, *rest, **kw)
        return call

    for name in ("kv_block_gather", "kv_block_scatter"):
        monkeypatch.setattr(serving_engine, name,
                            spy(getattr(serving_engine, name)))
    _, out_j = jeng.serve(trace6, budget_bytes=BUDGET, engine=_mem(False),
                          batch_transfers=True)
    _, out_t = teng.serve(trace6, budget_bytes=BUDGET, engine=_mem(True),
                          batch_transfers=True)
    assert out_t == out_j
    assert set(calls) == {"kv_block_gather", "kv_block_scatter"}
    assert after and all(p == ptrs for p in after)


def test_prefill_insert_generate_match_the_reference(engines):
    jeng, teng = engines
    for eng in (jeng, teng):
        eng._states.clear()
        eng._outputs.clear()
        eng._shadow.clear()
        eng._tok[:] = 0
    outs = []
    for eng in (jeng, teng):
        for slot, rid in enumerate(("a", "b")):
            eng.insert(eng.prefill(jeng.prompt_for(rid, PROMPT), rid=rid),
                       slot)
        outs.append([eng.generate() for _ in range(3)])
    assert outs[1] == outs[0]


def test_cli_serves_on_the_cpu(capsys):
    from repro_torch.serving.cli import main
    assert main(["--device", "cpu", "--requests", "3", "--prompt-len", "4",
                 "--gen", "4", "--budget-kb", "6"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "served=3" in out
    assert "oom_events=0" in out


def test_reduced_moe_serves_the_dense_path(other_engines):
    _, teng = other_engines("moonshot-v1-16b-a3b")
    assert teng.cfg.n_experts and teng.cfg.moe_impl == "dense"
    # the registry's config is untouched: full width serves the scatter
    assert get_config("moonshot-v1-16b-a3b").moe_impl == "scatter"


def test_batched_transfers_move_more_than_max_leaves_in_groups(
        other_engines, trace6, monkeypatch):
    """Jamba's cache has 30 slotted leaves (one attention layer's k and v,
    seven Mamba layers' four each): every batched save and restore makes
    one gather (and one scatter) call per consecutive group of at most
    ``MAX_LEAVES``, 16 then 14, and the tokens stay golden."""
    _, teng = other_engines("jamba-1.5-large-398b")
    n = len(teng._slotted()[1])
    assert n == 30 > kbc.MAX_LEAVES
    _, golden = teng.serve(trace6, budget_bytes=None, schedule=False)
    calls = []

    def spy(fn, name):
        def call(leaves, idx, *rest, **kw):
            calls.append((name, len(leaves)))
            return fn(leaves, idx, *rest, **kw)
        return call

    for name in ("kv_block_gather", "kv_block_scatter"):
        monkeypatch.setattr(serving_engine, name,
                            spy(getattr(serving_engine, name), name))
    budget = teng.bytes_per_token * (MAX_LEN * 2 + 2)
    rep, out = teng.serve(trace6, budget_bytes=budget, engine=_mem(True,
                                                                 budget),
                          batch_transfers=True)
    assert out == golden and rep.evictions > 0
    for name in ("kv_block_gather", "kv_block_scatter"):
        sizes = [k for c, k in calls if c == name]
        assert sizes and sizes == [16, 14] * (len(sizes) // 2)
