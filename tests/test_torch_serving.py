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


@pytest.fixture(scope="module")
def engines():
    jeng = JaxServingEngine("tinyllama-1.1b", max_sequences=4,
                            max_len=MAX_LEN, seed=0)
    teng = ServingEngine("tinyllama-1.1b", max_sequences=4, max_len=MAX_LEN,
                         seed=0, device="cpu")
    teng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                  teng.cfg, "cpu")
    teng.prompt_for = jeng.prompt_for     # the reference's prompts, as-is
    return jeng, teng


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


@pytest.mark.parametrize("batch_transfers", [False, True])
def test_engine_matches_the_reference(engines, trace6, batch_transfers):
    jeng, teng = engines
    mem_j, mem_t = _mem(False), _mem(True)
    rep_j, out_j = jeng.serve(trace6, budget_bytes=BUDGET, engine=mem_j,
                              batch_transfers=batch_transfers)
    rep_t, out_t = teng.serve(trace6, budget_bytes=BUDGET, engine=mem_t,
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
        def call(pool, idx, *rest):
            seen.append((name, pool.device.type, len(idx)))
            return fn(pool, idx, *rest)
        return call

    monkeypatch.setattr(serving_engine, "kv_block_gather",
                        spy(serving_engine.kv_block_gather, "gather"))
    monkeypatch.setattr(serving_engine, "kv_block_scatter",
                        spy(serving_engine.kv_block_scatter, "scatter"))
    launches = (kbc.kv_block_gather.launches, kbc.kv_block_scatter.launches)
    teng.serve(trace6, budget_bytes=BUDGET, engine=_mem(True),
               batch_transfers=True)
    assert {n for n, _, _ in seen} == {"gather", "scatter"}
    assert all(dev == "cpu" and k >= 2 for _, dev, k in seen)
    # the CPU path is the plain version: no kernel launched, none counted
    assert (kbc.kv_block_gather.launches,
            kbc.kv_block_scatter.launches) == launches


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
