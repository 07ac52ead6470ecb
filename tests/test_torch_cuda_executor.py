"""The port's executor on the card (marked ``cuda``; each test skips
without one): the copy stream's ordering against the compute stream, a
plan splice deferred by a prefetch on the wire, and the controller's one
copy stream for every job.
This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_executor.py

Tolerance 0 throughout: a swap copies and a recompute replays, so a
scheduled step is bit-identical to the unscheduled one under
deterministic algorithms (which also fix the order of the embedding
backward's additions), and a fetched copy equals what was parked.
"""
import dataclasses

import pytest
import torch

import repro_torch.core as tc
from repro_torch.core.executor import AsyncSwapExecutor, HostCopy
from repro_torch.kernels.offload_quant import packed_bytes, quantize_blocked
from repro_torch.kernels.ref import dequantize_blocked_ref


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


class _Deterministic:
    """Deterministic algorithms on (``torch.empty`` then fills new memory
    with NaN on the current stream), restored on exit."""

    def __enter__(self):
        self.prev = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.prev)


def _fetcher():
    """An executor of a tiny step, set up as ``run`` sets it up on the
    card, for calling its host fetch directly."""
    from repro_torch.service.workloads import make_mlp
    step, params, opt, batch = make_mlp((8, 16, 4), 4, device="cuda")
    seq, gm = tc.capture_train_step(step, params, opt, batch)
    ex = tc.FxExecutor(gm, seq, None, async_swap=True)
    ex.dev = torch.device("cuda")
    ex._compute = torch.cuda.current_stream()
    return ex


@pytest.mark.cuda
@pytest.mark.parametrize("compressed", [False, True])
def test_prefetch_lands_after_its_allocation(compressed):
    """A prefetch's destination is allocated on the compute stream and
    written on the copy stream.  The write must come after what the
    allocation queued on the compute stream (the NaN fill of deterministic
    algorithms), however far behind the compute stream runs: here a spin
    kernel holds it for tens of milliseconds."""
    _need_card()
    ex = _fetcher()
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    if compressed:
        # the executor's packed pinned buffer, filled on the host
        buf = torch.empty(packed_bytes(x.numel()), dtype=torch.int8,
                          pin_memory=True)
        q, s, meta = quantize_blocked(x, out=buf)
        ex.host["x"] = HostCopy((q, s, meta), tuple(x.shape),
                                tuple(x.stride()), x.dtype, True)
        want = dequantize_blocked_ref(q, s, meta)
    else:
        ex.host["x"] = HostCopy(x.pin_memory(), tuple(x.shape),
                                tuple(x.stride()), x.dtype, False)
        want = x
    copy = torch.cuda.Stream()
    with _Deterministic():
        # a first fetch loads the kernels (a module load waits for the
        # whole card) and warms the allocator
        with torch.cuda.stream(copy):
            ex._host_fetch("x")
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        with torch.cuda.stream(copy):
            got = ex._host_fetch("x")
        torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_packed_buffer_outlives_the_swap_in_that_reads_it():
    """A swap-in's dequantize reads its packed pinned buffer on the copy
    stream behind a spin kernel, while ``_host_put`` replaces the entry
    and the buffer's last reference goes.  PyTorch's caching host
    allocator does not see the kernel's read and would hand the memory out
    at once; the executor holds the buffer until the read has run, so a
    new owner that writes its pinned memory at once changes nothing."""
    _need_card()
    ex = _fetcher()
    ex.async_exec = AsyncSwapExecutor(ex.channel, ex.dev)
    copy = ex.async_exec.stream
    x = torch.randn(1 << 20, generator=torch.Generator().manual_seed(0))
    nbytes = packed_bytes(x.numel())
    q, s, meta = quantize_blocked(x, out=torch.empty(
        nbytes, dtype=torch.int8, pin_memory=True))
    want = dequantize_blocked_ref(q, s, meta)
    ex.host["x"] = HostCopy((q, s, meta), tuple(x.shape), tuple(x.stride()),
                            x.dtype, True)
    del q, s
    with torch.cuda.stream(copy):      # loads the kernels, warms up
        ex._host_fetch("x")
    torch.cuda.synchronize()
    with torch.cuda.stream(copy):
        torch.cuda._sleep(50_000_000)
        got = ex._host_fetch("x")
    ex._host_put("x", HostCopy(torch.zeros(1).pin_memory(), (1,), (1,),
                               torch.float32, False))
    assert len(ex._held) == 1
    junk = [torch.full((nbytes,), 0x7F, dtype=torch.int8, pin_memory=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    ex._release_held()
    assert not ex._held
    del junk


@pytest.mark.cuda
def test_scheduled_step_after_a_budgeted_ssm_serve_is_bit_identical(
        monkeypatch):
    """The order of ``chip_smoke.py``: a budgeted Mamba-2 serve (its
    state rows through the KV kernels and pinned host shadows), then a
    TENSILE step on the copy stream under deterministic algorithms, which
    must equal the unscheduled step bit for bit, under the ``tensile``
    plan and under the compressed-first plan's events uncompressed."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import build_functional_train_step
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim.adam import adamw_init
    from repro_torch.serving import ServingEngine, make_trace

    eng = ServingEngine("mamba2-780m", max_sequences=4, max_len=32, seed=0,
                        device="cuda")
    trace = make_trace("poisson", 6, seed=0, prompt_len=16, gen_len=16)
    budget = eng.bytes_per_token * (32 * 2 + 2)      # about 2 of 4 slots
    _, golden = eng.serve(trace, budget_bytes=None, schedule=False)
    rep, out = eng.serve(trace, budget_bytes=budget, engine=tc.MemoryEngine(
        tc.MachineProfile(), capacity_bytes=budget), batch_transfers=True)
    assert out == golden and rep.evictions > 0 and rep.oom_events == 0
    del eng

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = get_config("tinyllama-1.1b").reduced(remat="none", n_layers=2)
    api = get_model(cfg, "cuda")
    params = dict(TransformerLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0)).named_parameters())
    batch = api.input_specs(ShapeSpec("s", 64, 2, "train"), abstract=False)
    args = (params, adamw_init(params), batch)
    seq, gm = tc.capture_train_step(build_functional_train_step(api), *args)
    prof = tc.MachineProfile()
    unsched = tc.simulate([seq], None, prof, iterations=1).peak_bytes
    cfg_s = tc.SchedulerConfig(memory_budget_bytes=int(0.6 * unsched))
    plans = {}
    for name, passes in (("tensile", None), ("compressed-first", [
            tc.CompressedOffloadPass(), tc.SwapPass(), tc.RecomputePass()])):
        pipe = (tc.build_pipeline(name, prof, cfg_s) if passes is None else
                tc.Pipeline(passes, name=name, profile=prof, config=cfg_s))
        ms = tc.MemoryScheduler(prof, cfg_s, pipeline=pipe)
        ms.register_job(seq)
        plan = ms.schedule().plans[seq.job_id]
        exact = tc.SchedulingPlan(seq.job_id)
        for e in plan.events:
            exact.add(dataclasses.replace(e, compressed=False))
        exact.release_after_op.update(plan.release_after_op)
        assert any(e.event_type is tc.EventType.SWAP_IN for e in exact.events)
        plans[name] = exact
    with _Deterministic():
        want = tc.FxExecutor(gm, seq, None).run(*args)
        for name, plan in plans.items():
            ex = tc.FxExecutor(gm, seq, plan, async_swap=True)
            got = ex.run(*args)
            assert ex.stats.swap_in_count > 0, name
            assert all(torch.equal(a.cpu(), b.cpu())
                       for a, b in zip(got, want)), name


@pytest.mark.cuda
def test_splice_defers_while_a_prefetch_is_on_the_wire():
    """A prefetch issued behind a spin kernel on the compute stream is on
    the wire (issued, its event not reached): ``cancel_unstarted`` returns
    None and cancels nothing, even a queued prefetch, so a plan requested
    at this safe point waits; at the next safe point, the copy landed, it
    is spliced in."""
    _need_card()
    ex = _fetcher()
    ex.async_exec = AsyncSwapExecutor(ex.channel, ex.dev)
    x = torch.randn(1 << 22, generator=torch.Generator().manual_seed(0))
    for st in ("x", "y"):
        ex.host[st] = HostCopy(x.pin_memory(), tuple(x.shape),
                               tuple(x.stride()), x.dtype, False)
    with torch.cuda.stream(ex.async_exec.stream):     # warm-up
        ex._host_fetch("x")
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)          # the compute stream spins
    ex._swap_in("x", passive=False)
    ex.async_exec.flush()                   # issued behind the spin
    ex._swap_in("y", passive=False)         # queued, not issued
    assert ex.async_exec.cancel_unstarted("in:") is None
    assert [t.key for t in ex.async_exec.queue] == ["in:y"]
    prior = ex.plan
    newp = tc.SchedulingPlan(ex.seq.job_id)
    ex.request_plan(newp, {5, 6})
    ex._maybe_hot_swap(5)
    assert ex.stats.hot_swaps == 0 and ex.plan is prior
    assert ex._pending_plan is not None
    assert set(ex.async_exec.inflight) == {"in:x", "in:y"}
    torch.cuda.synchronize()
    ex._maybe_hot_swap(6)
    assert ex.stats.hot_swaps == 1 and ex.plan is newp
    assert ex.stats.canceled_swap_ins == 1       # y, never issued
    assert set(ex.async_exec.inflight) == {"in:x"}  # landed, not consumed
    ex.async_exec.wait("in:x")
    assert torch.equal(ex.device["x"].cpu(), x) and "y" not in ex.device


@pytest.mark.cuda
def test_two_jobs_transfers_issue_on_one_copy_stream(monkeypatch):
    """Under the controller every job's transfers go onto the device
    channel's one copy stream, each job computing on a stream of its own,
    and each job's result is the unscheduled step's bit for bit."""
    _need_card()
    from repro_torch.core import executor as executor_mod
    from repro_torch.service import JobSpec
    from repro_torch.service.workloads import make_mlp

    streams = []

    class Recording(AsyncSwapExecutor):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            streams.append((torch.cuda.current_stream(), self.stream))

    monkeypatch.setattr(executor_mod, "AsyncSwapExecutor", Recording)
    payloads = {j: make_mlp((256, 1024, 1024, 16), 64, seed=s,
                            device="cuda") for s, j in enumerate("ab")}
    want = {}
    with _Deterministic():
        for j, (step, params, opt, batch) in payloads.items():
            seq, gm = tc.capture_train_step(step, params, opt, batch)
            want[j] = tc.FxExecutor(gm, seq, None).run(params, opt, batch)
        gc = tc.GlobalController(profile=tc.MachineProfile(),
                                 pipeline_name="tensile+autoscale",
                                 arbiter_policy="equal",
                                 device_capacity=40 << 20)
        handles = [gc.submit(JobSpec(j, iterations=1, payload=p))
                   for j, p in payloads.items()]
        gc.wait(timeout=300)
    assert len(streams) == 2
    assert all(copy is gc.copy_stream for _, copy in streams)
    compute = [c for c, _ in streams]
    assert compute[0] != compute[1]
    assert torch.cuda.default_stream() not in compute
    assert any(h.stats[0].swap_out_count for h in handles)
    for h in handles:
        got = torch.utils._pytree.tree_leaves(h.args[:2])
        assert all(torch.equal(a.cpu(), b.cpu())
                   for a, b in zip(got, want[h.job_id]))
