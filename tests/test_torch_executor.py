"""The port's executor (``core.executor.FxExecutor``) against the port's
simulator and the JAX package's executor, on the CPU: torch twins of
``tests/test_engine_parity.py``'s parity tests, the sync and async swap
modes, recompute, the compressed path (through the quantize kernels'
plain versions, as a CPU tensor takes them), the across-iteration steady
state, and the reduced TinyLlama train step end to end.

Weights and data come from the JAX package (``tests/helpers.py``) as numpy.
Tolerances: a scheduled run is bit-equal to the unscheduled run of the
same graph (swaps copy, recompute replays the same node); against the JAX
reference's outputs rtol 1e-5, atol 1e-6 on the MLP, the reference's own
(``tests/test_engine_parity.py:80-82``); the reduced TinyLlama step
against the reference's step at the port's train-step tolerances
(``tests/test_torch_forward.py``: loss rtol 1e-4, parameters rtol 2e-2,
atol 2e-4); a compressed plan moves each parameter at most 2 x lr from
the exact run's (Adam's step is at most lr in size; on the LM step, plus
the fp32 rounding of the parameter), and its packed host buffers hold the
plain packing bit for bit.
"""
import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import repro.core as rc
from helpers import capture_mlp
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.launch import steps as jax_steps
from repro.models.registry import get_model as jax_get_model
from repro.optim.adam import adamw_init as jax_adamw_init
import repro_torch.core as tc
import repro_torch.core.executor as executor
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import DeviceLedger, DmaChannel
from repro_torch.kernels.offload_quant import packed_bytes
from repro_torch.kernels.ref import (dequantize_blocked_ref,
                                     quantize_blocked_ref)
from repro_torch.launch.steps import (TrainStepConfig,
                                      build_functional_train_step)
from repro_torch.models.registry import get_model
from repro_torch.optim import adam
from repro_torch.service.workloads import make_mlp
from test_torch_planner import port_profile

REF_PROFILE = rc.MachineProfile(host_link_bw=16e9, compute_flops=5e10,
                                mem_bw=1e10)
PROFILE = port_profile(REF_PROFILE)
# the reference's capture-time cost model (its CPU-container defaults)
CALIB = tc.DeviceCalibration(flops=5e10, mem_bw=1e10, overhead_s=2e-6)
LR = 1e-3


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def mlp():
    jseq, closed, args = capture_mlp(sizes=(64, 128, 128, 8), batch=16)
    ref_out = [np.asarray(o) for o in rc.reference_outputs(closed, *args)]
    step, params, opt, batch = make_mlp(
        (64, 128, 128, 8), 16, params=jax.tree.map(np.asarray, args[0]),
        data=tuple(np.asarray(a) for a in args[2]), device="cpu")
    seq, gm = tc.capture_train_step(step, params, opt, batch,
                                    cost_model=tc.CostModel(CALIB))
    plan = tc.schedule_single(seq, profile=PROFILE).plans[seq.job_id]
    args_t = (params, opt, batch)
    unsched = tc.FxExecutor(gm, seq, None).run(*args_t)
    return dict(seq=seq, gm=gm, plan=plan, args=args_t, ref=ref_out,
                unsched=unsched)


def _sim(seq, plan, **kw):
    eng = tc.MemoryEngine(PROFILE, trace=True)
    sim = tc.simulate([seq], {seq.job_id: plan} if plan else None, PROFILE,
                      iterations=1, transfer_mode="sync", engine=eng, **kw)
    return sim, eng


def _exec(m, plan, **kw):
    eng = tc.MemoryEngine(PROFILE, trace=True)
    ex = tc.FxExecutor(m["gm"], m["seq"], plan, engine=eng, **kw)
    out = ex.run(*m["args"])
    ex.close()
    return ex, eng, out


# ------------------------------------------------------- sim-vs-real parity
def test_sim_and_executor_identical_peak_and_event_order(mlp):
    seq, plan = mlp["seq"], mlp["plan"]
    assert plan.events, "plan must actually schedule something"
    sim, sim_eng = _sim(seq, plan)
    ex, ex_eng, out = _exec(mlp, plan)
    assert ex.stats.peak_bytes == sim.peak_bytes
    assert sim_eng.trace.keys() == ex_eng.trace.keys()
    assert ex.stats.swap_out_count > 0 and ex.stats.swap_in_count > 0
    # the scheduled run computes what the unscheduled one does, bit for bit,
    # and what the JAX reference computes within its own tolerance
    assert _equal(out, mlp["unsched"])
    assert len(out) == len(mlp["ref"])
    for a, b in zip(out, mlp["ref"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)


def test_sim_and_executor_identical_telemetry_records(mlp):
    seq, plan = mlp["seq"], mlp["plan"]
    schemas = tc.record_schemas()
    hub_sim = tc.TelemetryHub(clock="virtual")
    tc.simulate([seq], {seq.job_id: plan}, PROFILE, iterations=1,
                transfer_mode="sync", engine=tc.MemoryEngine(PROFILE),
                telemetry=hub_sim)
    hub_ex = tc.TelemetryHub(clock="real")
    ex = tc.FxExecutor(mlp["gm"], seq, plan,
                       engine=tc.MemoryEngine(PROFILE, telemetry=hub_ex))
    ex.run(*mlp["args"])
    j = seq.job_id
    for hub in (hub_sim, hub_ex):
        assert hub.ops[j] and hub.transfers[j] and hub.residency[j]
        for kind, recs in (("op", hub.ops[j]),
                           ("transfer", hub.transfers[j]),
                           ("residency", hub.residency[j])):
            assert tuple(f.name for f in dataclasses.fields(recs[0])) == \
                schemas[kind]
    sim_keys = [(r.action, r.storage) for r in hub_sim.residency[j]
                if r.iteration == 0]
    assert hub_ex.residency_keys(j) == sim_keys
    assert hub_sim.iterations(j) == hub_ex.iterations(j) == 1
    assert ex.stats.residency_timeline
    assert tc.record_schemas() == rc.record_schemas()


def test_sim_and_executor_identical_without_plan(mlp):
    sim, sim_eng = _sim(mlp["seq"], None)
    ex, ex_eng, out = _exec(mlp, None)
    assert ex.stats.peak_bytes == sim.peak_bytes
    assert sim_eng.trace.keys() == ex_eng.trace.keys()
    assert ex.stats.swap_out_count == ex.stats.recompute_count == 0


def test_async_mode_batches_transfers_and_matches(mlp):
    plan = mlp["plan"]
    sync, _, _ = _exec(mlp, plan)
    ex, _, out = _exec(mlp, plan, async_swap=True)
    assert _equal(out, mlp["unsched"])
    assert (ex.stats.swap_out_count, ex.stats.swap_in_count) == \
        (sync.stats.swap_out_count, sync.stats.swap_in_count)
    launches = ex.async_exec.batches
    assert sum(len(b) for b in launches) == (ex.stats.swap_out_count +
                                             ex.stats.swap_in_count -
                                             ex.stats.passive_swap_ins)
    assert all(len({k.split(":")[0] for k in b}) == 1 for b in launches)
    assert all(len(b) <= tc.AsyncSwapExecutor.MAX_BATCH for b in launches)
    assert not ex.async_exec.inflight


def test_ledger_books_a_released_swap_out_until_it_lands(mlp, monkeypatch):
    """An async swap-out's copy holds its device tensor until it lands,
    also when the storage leaves the store first (here: released at its
    last use): the ledger keeps those bytes booked until the copy is
    retired.  The plan swaps out the activation with the longest live
    range right after its producer.  On the CPU a copy lands at issue, so
    here each lands only after as many polls as that range spans, as a
    copy queued on a busy copy stream does; at every poll, before it
    retires anything, the ledger must cover the store's storages and
    every pending copy's tensor that the store no longer holds.  On a card
    the ledger freed them at the release: 1.25 GB under the allocator in
    whisper's scheduled step."""
    seq = mlp["seq"]
    tid = max((t for t, spec in seq.tensors.items()
               if spec.kind is tc.TensorKind.ACTIVATION
               and seq.tga(t) is not None),
              key=lambda t: seq.last_access(t).op_idx - seq.tga(t).op_idx)
    p, u = seq.tga(tid).op_idx, seq.last_access(tid).op_idx
    plan = tc.SchedulingPlan(seq.job_id)
    plan.add(tc.ScheduleEvent(tc.EventType.SWAP_OUT, tid, seq.job_id,
                              trigger_op=p, delta=0.0, start=seq.op_end[p],
                              end=seq.op_end[p],
                              size_bytes=seq.tensors[tid].size_bytes))
    polls, seen, blocking = collections.Counter(), [], [False]
    done = executor.Transfer.done
    monkeypatch.setattr(executor.Transfer, "done", lambda t: done(t) and (
        blocking[0] or polls[t.key] > u - p))
    poll = tc.FxExecutor._poll_swap_outs

    def checked(self, block=False):
        job = self.ctx.job_id
        held = sum(self.accountant.resident_bytes(job, st)
                   for st in self.device)
        off_store = [st for st, (_, _, val) in self._pending_out.items()
                     if self.device.get(st) is not val]
        held += sum(self.ctx.size_of(st) for st in off_store)
        seen.extend(off_store)
        assert self.accountant.job_bytes(job) >= held, off_store
        for t, _, _ in self._pending_out.values():
            polls[t.key] += 1
        blocking[0] = block
        try:
            return poll(self, block)
        finally:
            blocking[0] = False

    monkeypatch.setattr(tc.FxExecutor, "_poll_swap_outs", checked)
    ex, _, out = _exec(mlp, plan, async_swap=True)
    assert _equal(out, mlp["unsched"])
    assert seen and set(seen) == {tid}
    assert ex.stats.swap_out_count == 1
    assert not any(k.startswith(executor.ON_WIRE)
                   for _, k in ex.accountant._resident)


def test_recompute_replays_the_producer(mlp):
    seq = mlp["seq"]
    tight = port_profile(rc.MachineProfile(host_link_bw=1.0,
                                           host_link_latency=100.0,
                                           compute_flops=1e9, mem_bw=1e9))
    sched = tc.MemoryScheduler(tight, tc.SchedulerConfig(
        memory_budget_bytes=1))
    sched.register_job(seq)
    plan = sched.schedule().plans[seq.job_id]
    assert any(e.event_type is tc.EventType.RECOMPUTE for e in plan.events)
    sim, sim_eng = _sim(seq, plan)
    ex, ex_eng, out = _exec(mlp, plan)
    assert ex.stats.recompute_count > 0
    assert ex.stats.peak_bytes == sim.peak_bytes
    assert sim_eng.trace.keys() == ex_eng.trace.keys()
    assert _equal(out, mlp["unsched"])


@pytest.mark.parametrize("async_swap", [False, True])
def test_compressed_swaps_go_through_the_quantize_path(mlp, async_swap):
    seq, plan = mlp["seq"], mlp["plan"]
    comp = tc.SchedulingPlan(seq.job_id)
    for e in plan.events:
        act = seq.tensors[e.tensor_id].kind is tc.TensorKind.ACTIVATION
        comp.add(dataclasses.replace(e, compressed=act and e.event_type in (
            tc.EventType.SWAP_OUT, tc.EventType.SWAP_IN)))
    comp.release_after_op.update(plan.release_after_op)
    assert any(e.compressed for e in comp.events)
    sim, _ = _sim(seq, comp)
    ex, _, out = _exec(mlp, comp, async_swap=async_swap)
    assert ex.stats.compressed_swaps > 0
    if not async_swap:
        assert ex.stats.peak_bytes == sim.peak_bytes
    n_params = len(pytree.tree_leaves(mlp["args"][0]))
    for a, b in zip(out[:n_params], mlp["unsched"][:n_params]):
        assert float((a - b).abs().max()) <= 2 * LR
    assert all(bool(torch.isfinite(o).all()) for o in out)


def test_host_resident_inputs_carry_across_iterations(mlp):
    seq, gm, plan = mlp["seq"], mlp["gm"], mlp["plan"]
    params, opt, batch = mlp["args"]
    n_state = len(pytree.tree_leaves((params, opt)))
    spec = pytree.tree_structure((params, opt, batch))
    b = pytree.tree_leaves(batch)
    ex1 = tc.FxExecutor(gm, seq, plan, async_swap=True)
    out1 = ex1.run(params, opt, batch)
    parked = ex1.ending_host_storages()
    assert parked, "the plan parks state on the host across iterations"
    ex2 = tc.FxExecutor(gm, seq, plan, async_swap=True,
                        host_resident_inputs=parked)
    out2 = ex2.run(*pytree.tree_unflatten(out1[:n_state] + b, spec))
    ref2 = tc.reference_outputs(gm, *pytree.tree_unflatten(
        mlp["unsched"][:n_state] + b, spec))
    assert _equal(out2, ref2)
    assert ex2.stats.peak_bytes <= ex1.stats.peak_bytes


def test_run_donated_takes_the_arguments(mlp):
    """Donated parameters and moments are updated in their own storage
    (the ``out`` form of the op that writes them); ``run`` writes none of
    the caller's tensors."""
    seq, gm = mlp["seq"], mlp["gm"]
    args = pytree.tree_map(lambda x: x.clone(), mlp["args"])
    n_state = len(pytree.tree_leaves(args[:2]))
    ptrs = [x.data_ptr() for x in pytree.tree_leaves(args)][:n_state]
    box = list(args)
    del args
    out = tc.FxExecutor(gm, seq, None).run_donated(box)
    assert box == [] and _equal(out, mlp["unsched"])
    reused = sum(o.data_ptr() == p for o, p in zip(out[:n_state], ptrs))
    assert reused >= n_state - 1              # all but the step counter
    kept = pytree.tree_map(lambda x: x.clone(), mlp["args"])
    tc.FxExecutor(gm, seq, None).run(*mlp["args"])
    assert _equal(pytree.tree_leaves(mlp["args"]), pytree.tree_leaves(kept))


def test_engine_pieces_are_the_shared_ones():
    led = DeviceLedger()
    assert led.alloc("j", "a", 100, 0.0) and not led.alloc("j", "a", 1, 1.0)
    ch = DmaChannel(coalesce=True, coalesce_window=1.0, batch_overhead_s=0.1)
    assert ch.transfer_batch([lambda: 1, lambda: 2]) == [1, 2]
    assert ch.batched_transfers == 1
    s, e = ch.acquire(0.0, 1.0, direction="in")
    assert ch.try_refund(s, e) and ch.busy_until == 0.0


# -------------------------------------------------------------- optimizer
@pytest.mark.parametrize("use_master,clip", [(False, None), (False, 1.0),
                                             (True, 0.5)])
def test_adamw_step_equals_inplace_adamw_update(use_master, clip):
    rng = np.random.default_rng(0)

    def tree(dtype):
        return {k: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dtype) for k, s in (("a", (4, 5)), ("b", (7,)))}

    params, grads = tree(torch.bfloat16), tree(torch.bfloat16)
    state = adam.adamw_init(params, use_master=use_master)
    state = state._replace(mu=tree(torch.float32), nu={
        k: v.abs() for k, v in tree(torch.float32).items()})
    kw = dict(lr=1e-2, weight_decay=0.01, grad_clip_norm=clip)
    new_p, new_s = adam.adamw_step(params, grads, state, **kw)
    p2 = {k: v.clone() for k, v in params.items()}
    s2 = state._replace(mu={k: v.clone() for k, v in state.mu.items()},
                        nu={k: v.clone() for k, v in state.nu.items()},
                        master=({k: v.clone() for k, v in
                                 state.master.items()} if use_master else ()))
    adam.adamw_update(p2, grads, s2, **kw)
    for k in params:
        assert torch.equal(new_p[k], p2[k])
        assert torch.equal(new_s.mu[k], s2.mu[k])
        assert torch.equal(new_s.nu[k], s2.nu[k])
        if use_master:
            assert torch.equal(new_s.master[k], s2.master[k])
    assert int(new_s.step) == 1
    assert not torch.equal(new_p["a"], params["a"])    # inputs untouched


# ------------------------------------------------- the slice as a whole
@pytest.fixture(scope="module")
def lm():
    jcfg = jax_config("tinyllama-1.1b").reduced(remat="none", n_layers=2)
    tcfg = get_config("tinyllama-1.1b").reduced(remat="none", n_layers=2)
    japi = jax_get_model(jcfg)
    jparams, _ = japi.init(jax.random.PRNGKey(0))
    jopt = jax_adamw_init(jparams)
    jbatch = japi.input_specs(JShapeSpec("s", 64, 2, "train"),
                              abstract=False)
    jp, jo, jm = jax_steps.build_train_step(japi, None)(jparams, jopt, jbatch)
    api = get_model(tcfg, "cpu")
    params = dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  "cpu").named_parameters())
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in jbatch.items()}
    args = (params, adam.adamw_init(params), batch)
    seq, gm = tc.capture_train_step(build_functional_train_step(api), *args)
    jflat = {".".join(str(k.key) for k in path): np.asarray(v) for path, v
             in jax.tree_util.tree_leaves_with_path(jp)}
    return dict(seq=seq, gm=gm, args=args, jparams=jflat,
                jloss=float(jm["loss"]))


@pytest.mark.parametrize("pipeline", ["tensile",
                                      "tensile+compressed-offload"])
def test_reduced_lm_step_under_a_budget(lm, pipeline):
    seq, gm, args = lm["seq"], lm["gm"], lm["args"]
    prof = tc.MachineProfile()
    unsched = tc.simulate([seq], None, prof, iterations=1).peak_bytes
    cfg = tc.SchedulerConfig(memory_budget_bytes=int(0.6 * unsched))
    ms = tc.MemoryScheduler(prof, cfg, pipeline=tc.build_pipeline(
        pipeline, prof, cfg))
    ms.register_job(seq)
    plan = ms.schedule().plans[seq.job_id]
    assert plan.events
    base = tc.FxExecutor(gm, seq, None).run(*args)
    for async_swap in (False, True):
        sim, _ = _sim(seq, plan)
        eng = tc.MemoryEngine(prof, trace=True)
        ex = tc.FxExecutor(gm, seq, plan, engine=eng, async_swap=async_swap)
        out = ex.run(*args)
        assert ex.stats.peak_bytes < unsched
        if not async_swap:
            assert ex.stats.peak_bytes == sim.peak_bytes
        assert _equal(out, base)
    # ... and the port's step is the reference's step
    n = len(args[0])
    loss = float(out[3 * n + 1])
    assert np.isclose(loss, lm["jloss"], rtol=1e-4)
    new_params = dict(zip(args[0], out[:n]))
    assert set(new_params) == set(lm["jparams"])
    for k, v in new_params.items():
        np.testing.assert_allclose(v.numpy(), lm["jparams"][k], rtol=2e-2,
                                   atol=2e-4)


def test_compressed_swap_of_an_integer_tensor_is_exact(lm):
    """A compressed plan event on an integer tensor (the token ids) moves
    it at full precision: int8 blocks would destroy the ids."""
    seq, gm, args = lm["seq"], lm["gm"], lm["args"]
    ints = [t for t in seq.initial_resident if seq.tensors[t].dtype.startswith(
        "int") and len(seq.tensor_accesses(t)) >= 2]
    assert ints
    tid = ints[0]
    first, second = seq.tensor_accesses(tid)[:2]
    plan = tc.SchedulingPlan(seq.job_id)
    size = seq.tensors[tid].size_bytes
    plan.add(tc.ScheduleEvent(
        event_type=tc.EventType.SWAP_OUT, tensor_id=tid, job_id=seq.job_id,
        trigger_op=first.op_idx, delta=0.0, start=first.end_time,
        end=first.end_time, size_bytes=size, compressed=True))
    plan.add(tc.ScheduleEvent(
        event_type=tc.EventType.SWAP_IN, tensor_id=tid, job_id=seq.job_id,
        trigger_op=second.op_idx - 1, delta=0.0, start=second.time,
        end=second.time, size_bytes=size, target_op=second.op_idx,
        compressed=True))
    ex = tc.FxExecutor(gm, seq, plan)
    out = ex.run(*args)
    assert ex.stats.swap_out_count == 1 and ex.stats.compressed_swaps == 0
    assert _equal(out, tc.FxExecutor(gm, seq, None).run(*args))


def test_compressed_swaps_fill_one_packed_buffer_each(lm, monkeypatch):
    """The reduced TinyLlama step under the compressed-first plan
    (compressed, swap, recompute): each compressed swap-out is one quantize
    call into one packed host buffer whose bytes are the plain packing of
    the value swapped out; each compressed host copy is its rows and scales
    as views of that buffer; the step's loss is the exact step's and its
    parameters within 2 lr of it."""
    seq, gm, args = lm["seq"], lm["gm"], lm["args"]
    prof = tc.MachineProfile()
    unsched = tc.simulate([seq], None, prof, iterations=1).peak_bytes
    cfg = tc.SchedulerConfig(memory_budget_bytes=int(0.6 * unsched),
                             patience_iters=10 ** 4)
    ms = tc.MemoryScheduler(prof, cfg, pipeline=tc.Pipeline(
        [tc.CompressedOffloadPass(), tc.SwapPass(), tc.RecomputePass()],
        profile=prof, config=cfg))
    ms.register_job(seq)
    plan = ms.schedule().plans[seq.job_id]
    assert any(e.compressed for e in plan.events)
    calls = []
    quantize = executor.quantize_blocked

    def spy(x, out=None, **kw):
        calls.append((x.clone(), out))
        return quantize(x, out=out, **kw)

    monkeypatch.setattr(executor, "quantize_blocked", spy)
    base = tc.FxExecutor(gm, seq, None).run(*args)
    n = len(args[0])
    lr = TrainStepConfig().learning_rate
    for async_swap in (False, True):
        calls.clear()
        ex = tc.FxExecutor(gm, seq, plan, async_swap=async_swap)
        out = ex.run(*args)
        assert len(calls) >= ex.stats.compressed_swaps > 0
        for x, buf in calls:
            q, s, _ = quantize_blocked_ref(x)
            assert buf.dim() == 1 and buf.numel() == packed_bytes(x.numel())
            assert torch.equal(buf, torch.cat([q.reshape(-1),
                                               s.reshape(-1).view(
                                                   torch.int8)]))
        parked = [r.data for r in ex.host.values() if r.compressed]
        assert parked
        for q, s, meta in parked:
            st = q.untyped_storage()
            assert st.data_ptr() == s.untyped_storage().data_ptr()
            assert st.nbytes() == packed_bytes(q.shape[0] * q.shape[1]
                                               - meta[2])
        assert np.isclose(float(out[3 * n + 1]), float(base[3 * n + 1]),
                          rtol=1e-4)
        for a, b in zip(out[:n], base[:n]):
            tol = 2 * lr + 2 * torch.finfo(b.dtype).eps * float(
                b.abs().max())
            assert float((a - b).abs().max()) <= tol


@pytest.mark.parametrize("extra_rows,copied", [(None, False), (0, False),
                                                (1, True)])
def test_fetch_packed_copies_only_above_the_zero_copy_size(
        extra_rows, copied, monkeypatch):
    """The compressed swap-in's size rule: a packed buffer of at most
    ``ZERO_COPY_MAX_BYTES`` is read where it lies, a larger one after one
    copy (on the card: to the card); one dequantize either way, with the
    same values.  Cases: one row, the most rows that fit, one more."""
    fit = executor.ZERO_COPY_MAX_BYTES // packed_bytes(1)
    rows = 1 if extra_rows is None else fit + extra_rows
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        rows * 512).astype(np.float32))
    buf = torch.empty(packed_bytes(x.numel()), dtype=torch.int8)
    q, s, meta = executor.quantize_blocked(x, out=buf)
    read = []
    dequantize = executor.dequantize_blocked

    def spy(q, s, meta, out):
        read.append(q.data_ptr())
        return dequantize(q, s, meta, out=out)

    monkeypatch.setattr(executor, "dequantize_blocked", spy)
    out = torch.empty_like(x)
    assert executor.fetch_packed(q, s, meta, out) is out
    assert len(read) == 1 and (read[0] != buf.data_ptr()) == copied
    assert torch.equal(out, dequantize_blocked_ref(q, s, meta))


@pytest.mark.parametrize("fill", [False, True])
def test_empty_unfilled_skips_the_fill_and_restores_the_setting(fill):
    """``empty_unfilled`` allocates with the deterministic fill of new memory
    off, and leaves the setting as it found it, also when it raises."""
    det = torch.utils.deterministic
    prev, prev_det = (det.fill_uninitialized_memory,
                      torch.are_deterministic_algorithms_enabled())
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = fill
    try:
        h = executor.empty_unfilled((3, 4), (1, 3), torch.float32)
        assert (h.shape, h.stride(), h.dtype) == ((3, 4), (1, 3),
                                                  torch.float32)
        assert det.fill_uninitialized_memory is fill
        with pytest.raises(RuntimeError):
            executor.empty_unfilled((-1,), (1,), torch.float32)
        assert det.fill_uninitialized_memory is fill
    finally:
        det.fill_uninitialized_memory = prev
        torch.use_deterministic_algorithms(prev_det)


def test_run_takes_the_state_as_one_flat_list(mlp):
    """``run`` flattens its arguments, so the flat list of leaves that
    ``run_donated`` consumes also runs without being donated."""
    seq, gm = mlp["seq"], mlp["gm"]
    out = tc.FxExecutor(gm, seq, None).run(list(pytree.tree_leaves(
        mlp["args"])))
    assert _equal(out, mlp["unsched"])


# ------------------------------------------------------------ budget guard
class _LandsOnSync:
    """A copy-stream event that lands when waited for."""

    def __init__(self):
        self.waited = False

    def synchronize(self):
        self.waited = True

    def query(self):
        return self.waited


def _guarded(mlp, budget):
    """An executor mid-run on the CPU: the MLP's inputs booked, and one
    swap-out of its largest input issued and still on the wire."""
    ex = tc.FxExecutor(mlp["gm"], mlp["seq"], mlp["plan"], async_swap=True,
                       engine=tc.MemoryEngine(PROFILE), budget_bytes=budget)
    ex.dev = torch.device("cpu")
    ex.async_exec = tc.AsyncSwapExecutor(ex.channel, ex.dev)
    lay = ex.layout
    for n, v in zip(lay.inputs, pytree.tree_leaves(mlp["args"])):
        ex._put_device(lay.tid[n], v)
    st = max(ex.device, key=ex.ctx.size_of)
    val = ex.device[st]
    t = executor.Transfer("out:" + st, lambda: ex._host_put(
        st, ex._to_host(val, False)))
    t.fn()
    t.issued, t.event = True, _LandsOnSync()
    ex.async_exec.inflight[t.key] = t
    ex._pending_out[st] = (t, False, val)
    return ex, st, t


@pytest.mark.parametrize("over", [False, True])
def test_budget_guard_waits_for_swap_outs_on_the_wire(mlp, over):
    """Booking past ``budget_bytes`` first waits for the issued swap-outs
    and retires them (the device copy leaves the ledger); within the
    budget, or with no budget, nothing waits."""
    probe, _, _ = _guarded(mlp, None)
    booked = probe.accountant.job_bytes(probe.ctx.job_id)
    probe._hold_budget(1 << 40)
    assert probe._pending_out and probe.stats.budget_waits == 0
    incoming = 4096
    budget = booked + incoming - (1 if over else 0)
    ex, st, t = _guarded(mlp, budget)
    ex._hold_budget(incoming)
    assert t.event.waited is over
    assert (st not in ex.device) is over
    assert (st in ex._pending_out) is not over
    assert ex.stats.budget_waits == int(over)
    if over:
        assert ex.accountant.job_bytes(ex.ctx.job_id) \
            == booked - ex.ctx.size_of(st)
        assert ex.stats.swap_out_count == 1 and st in ex.host


@pytest.mark.parametrize("plan", [False, True])
@pytest.mark.parametrize("async_swap", [False, True])
def test_budget_guard_holds_the_slice_and_the_values(mlp, plan, async_swap):
    """A run under a budget below its own peak (0.7 of the unscheduled
    peak, and of the plan's): the guard swaps out what is read again last,
    the readers swap it back in, the ledger stays within the budget and the
    outputs are the unscheduled run's bit for bit, again in a second
    iteration from the state the first left on the host."""
    p = mlp["plan"] if plan else None
    free, _, _ = _exec(mlp, p, async_swap=async_swap)
    budget = int(0.7 * free.stats.peak_bytes)
    ex, eng, out = _exec(mlp, p, async_swap=async_swap, budget_bytes=budget)
    assert _equal(out, mlp["unsched"])
    assert ex.stats.budget_evictions > 0
    assert eng.ledger.peak <= budget < free.stats.peak_bytes
    assert ex.stats.swap_in_count >= ex.stats.passive_swap_ins > 0
    # the second iteration: the state the first parked on the host enters
    # as host-resident inputs, with no stale copy of an evicted activation
    parked = {st: ex.host[st] for st in ex.ending_host_storages()}
    ex2 = tc.FxExecutor(mlp["gm"], mlp["seq"], p, async_swap=async_swap,
                        engine=tc.MemoryEngine(PROFILE), budget_bytes=budget,
                        host_resident_inputs=set(parked))
    ex2.host.update(parked)
    out2 = ex2.run(*_state_of(mlp, out))
    ex2.close()
    ref2 = tc.FxExecutor(mlp["gm"], mlp["seq"], None).run(
        *_state_of(mlp, mlp["unsched"]))
    assert _equal(out2, ref2)


def test_budget_guard_evicts_landed_prefetches_for_an_operator():
    """A plan whose operator needs more than the guard can evict from the
    storages it was not fetching: the multi-job test's job (the 64-256-
    256-8 MLP, batch 16, seed 1) at 0.6 of its unscheduled peak, planned
    by ``tensile+autoscale`` over latencies drawn from numpy seed 25 (each
    the cost model's times 10**U(0, 3): a controller's drift replan over
    measured latencies of a loaded host).  At operator 82 the op holds
    786,432 B of its own and two landed prefetches 524,288 B; the guard
    once skipped every storage with a prefetch in flight, and the ledger
    ran 68,317 B over its 1,242,403 B.  It now waits for such a prefetch
    and swaps it out: the ledger stays within the slice and the outputs
    are the unscheduled run's bit for bit."""
    sizes, batch = (64, 256, 256, 8), 16
    step, params, opt, data = make_mlp(sizes, batch, seed=1, device="cpu")
    seq, gm = tc.capture_train_step(step, params, opt, data, job_id="j1",
                                    cost_model=tc.CostModel(CALIB))
    free = tc.FxExecutor(gm, seq, None)
    unsched = free.run(params, opt, data)
    cap = int(0.6 * free.accountant.peak)
    rng = np.random.default_rng(25)
    seq.set_latencies([op.latency * f for op, f in zip(
        seq.operators, 10.0 ** rng.uniform(0, 3, len(seq.operators)))])
    pipe = tc.build_pipeline("tensile+autoscale", profile=PROFILE,
                             config=tc.SchedulerConfig())
    sched = tc.MemoryScheduler(PROFILE, tc.SchedulerConfig(), pipeline=pipe)
    sched.register_job(seq)
    plan = sched.schedule(["j1"], budgets={"j1": cap}).plans["j1"]
    assert plan.planned_peak_bytes > cap
    ex = tc.FxExecutor(gm, seq, plan, async_swap=True, budget_bytes=cap,
                       engine=tc.MemoryEngine(PROFILE))
    out = ex.run(params, opt, data)
    assert ex.stats.budget_evictions > 0
    assert ex.accountant.peak <= cap
    assert _equal(out, unsched)


def test_budget_guard_raises_where_an_operator_cannot_fit(mlp):
    """A slice smaller than what one operator must hold at once cannot be
    kept: the guard says so rather than run over it."""
    ex = tc.FxExecutor(mlp["gm"], mlp["seq"], mlp["plan"], async_swap=True,
                       engine=tc.MemoryEngine(PROFILE), budget_bytes=1)
    with pytest.raises(tc.BudgetExceededError, match="budget 1 B"):
        ex.run(*mlp["args"])
    assert ex.accountant.peak <= 1


def _state_of(mlp, outs):
    """The step's arguments for the next iteration: the parameters and
    moments ``outs`` holds, the same batch."""
    params, opt, batch = mlp["args"]
    p_spec = pytree.tree_structure(params)
    o_spec = pytree.tree_structure(opt)
    n_p, n_o = p_spec.num_leaves, o_spec.num_leaves
    return (pytree.tree_unflatten(list(outs[:n_p]), p_spec),
            pytree.tree_unflatten(list(outs[n_p:n_p + n_o]), o_spec), batch)


def test_executor_floor_is_the_executor_s_per_operator_time():
    floor = tc.executor_floor("cpu")
    assert 0 < floor < 0.05
