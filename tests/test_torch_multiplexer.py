"""The port's multi-job runtime (``core.multiplexer``: ``BudgetArbiter``,
``GlobalController``; ``FxExecutor.request_plan``; ``AsyncSwapExecutor.
cancel_unstarted``) and its plain-Python copies (``service.jobspec``, the
workload registry, ``obs.events``) against the JAX package's, on the CPU.

Inputs are the reference's (``tests/helpers.py``: the MLP of
``tests/test_hotswap.py`` and ``tests/test_arbiter.py``, weights and data
as numpy), or plain numbers.  Tolerances: the arbiter's splits, victims,
remainder plans and preemption decisions are the same Python arithmetic
on the same inputs, so they compare exactly (a sequence the reference
captured is converted field by field, ``test_torch_planner.to_port``); a
hot-swapped run is bit-equal to the unscheduled run of the same graph and
within the reference test's rtol 1e-5, atol 1e-6 of the JAX reference's
outputs.
"""
import dataclasses
import enum
import importlib.util
import os
import runpy
import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch

import repro.core as rc
from helpers import capture_mlp
from repro.obs.events import EventLog as RefEventLog
from repro.service import jobspec as ref_jobspec
from repro.service import workloads as ref_workloads
import repro_torch.core as tc
from repro_torch.core.executor import AsyncSwapExecutor
from repro_torch.obs.events import EventLog
from repro_torch.service import jobspec, workloads
from repro_torch.service import JobSpec, ServeParams, make_mlp
from test_torch_planner import port_profile, to_port

REF_PROFILE = rc.MachineProfile(host_link_bw=16e9, compute_flops=5e10,
                                mem_bw=1e10)
PROFILE = port_profile(REF_PROFILE)
# the reference's capture-time cost model (its CPU-container defaults)
CALIB = tc.DeviceCalibration(flops=5e10, mem_bw=1e10, overhead_s=2e-6)
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def vic():
    """The reference hot-swap tests' MLP, captured by both packages."""
    jseq, closed, jargs = capture_mlp(sizes=(64, 128, 128, 8), batch=16,
                                      job_id="vic")
    ref = [np.asarray(o) for o in rc.reference_outputs(closed, *jargs)]
    step, params, opt, batch = make_mlp(
        (64, 128, 128, 8), 16, params=jax.tree.map(np.asarray, jargs[0]),
        data=tuple(np.asarray(a) for a in jargs[2]), device="cpu")
    seq, gm = tc.capture_train_step(step, params, opt, batch, job_id="vic",
                                    cost_model=tc.CostModel(CALIB))
    args = (params, opt, batch)
    unsched = tc.FxExecutor(gm, seq, None).run(*args)
    return dict(jseq=jseq, closed=closed, jargs=jargs, ref=ref, seq=seq,
                gm=gm, args=args, unsched=unsched)


def _remainder(mod, seq, profile, prior, op: int, frac: float):
    """``replan_from`` of ``tensile+autoscale`` at safe point ``op`` for a
    slice of ``frac`` of the sequence's scheduled peak."""
    pipe = mod.build_pipeline("tensile+autoscale", profile=profile,
                              config=mod.SchedulerConfig())
    new_slice = int(mod.analyze([seq]).peak_bytes * frac)
    return pipe.replan_from([seq], {seq.job_id: prior},
                            {seq.job_id: op},
                            budgets={seq.job_id: new_slice}
                            ).plans[seq.job_id]


def _plain(x):
    """Enums as their values, recursively: the two packages' plan dicts
    hold equal numbers and names."""
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


# ------------------------------------------------------------- the arbiter
@pytest.mark.parametrize("policy", sorted(rc.ARBITER_POLICIES))
def test_split_matches_the_reference(policy):
    """Every policy splits alike: weights, the water-fill cap at demand,
    a measured demand folded in, a prior, and the redistribution after a
    departure."""
    assert sorted(tc.ARBITER_POLICIES) == sorted(rc.ARBITER_POLICIES)
    assert tc.ARBITER_MODES == rc.ARBITER_MODES
    runs = []
    for mod in (rc, tc):
        arb = mod.BudgetArbiter(1_000_000, policy=policy)
        arb.register("tiny", priority=1.0, demand_bytes=20_000)
        arb.register("mid", priority=2.0, demand_bytes=400_000)
        arb.register("big", priority=3.0, demand_bytes=0)   # uncapped
        arb.register("pri", priority=0.5, demand_bytes=900_000)
        arb.set_prior("pri", types.SimpleNamespace(stall_share=0.4,
                                                   peak_bytes=700_000))
        live = ["tiny", "mid", "big", "pri"]
        splits = [arb.split(live)]
        arb.update_demand("mid", 450_000)
        splits.append(arb.split(live))
        arb.unregister("big")                 # a departure re-flows its bytes
        splits.append(arb.split(["tiny", "mid", "pri"]))
        splits.append(arb.split([]))
        runs.append((splits, arb.history, arb.last_assignment,
                     arb.demands, arb.live_peak_seen))
    assert runs[1] == runs[0]
    splits = runs[1][0]
    for s in splits:
        assert sum(s.values()) <= 1_000_000
    assert splits[0]["tiny"] <= 20_000
    assert sum(splits[2].values()) >= sum(
        v for j, v in splits[1].items() if j != "big")
    with pytest.raises(KeyError):
        tc.BudgetArbiter(100, policy="no-such-policy")
    with pytest.raises(KeyError):
        tc.BudgetArbiter(100, mode="no-such-mode")


def test_victims_match_the_reference():
    new = {"a": 100, "b": 300, "c": 50, "d": 10}
    prev = {"a": 200, "b": 250, "c": 80}
    usage = {"a": 150, "b": 400, "c": 90, "d": 100}
    got = tc.BudgetArbiter(1000).victims(new, prev, usage)
    assert got == rc.BudgetArbiter(1000).victims(new, prev, usage)
    assert got == ["a", "c"]       # shrank and over; largest over-share first


# ------------------------------------------------- the executor's splice
def test_replan_from_plans_match_the_reference(vic):
    """On the reference's sequence, the port finds the same safe points and
    builds the same remainder plan at each: the plan a hot-swap adopts."""
    jseq = vic["jseq"]
    port = to_port(jseq)
    rsps = rc.find_safe_points(jseq, rc.SchedulingPlan(job_id="vic"))
    psps = tc.find_safe_points(port, tc.SchedulingPlan(job_id="vic"))
    assert [dataclasses.astuple(s) for s in psps] == \
        [dataclasses.astuple(s) for s in rsps]
    assert rsps
    for sp in rsps[:3]:
        r = _remainder(rc, jseq, REF_PROFILE, rc.SchedulingPlan("vic"),
                       sp.op_idx, 0.7)
        p = _remainder(tc, port, PROFILE, tc.SchedulingPlan("vic"),
                       sp.op_idx, 0.7)
        assert _plain(p.to_dict()) == _plain(r.to_dict())
        assert p.events


@pytest.mark.parametrize("async_swap", [False, True])
def test_request_plan_hot_swaps_at_a_safe_point(vic, async_swap):
    """The executor splices a pending plan in at a safe point mid-iteration
    (once, adopting that very plan, whose swap-outs then run) and computes
    what the unscheduled run computes; the reference's executor, given the
    same ``replan_from`` inputs on its own capture, does likewise."""
    seq = vic["seq"]
    prior = tc.SchedulingPlan(job_id="vic")
    sps = tc.find_safe_points(seq, prior)
    assert sps
    newp = _remainder(tc, seq, PROFILE, prior, sps[0].op_idx, 0.7)
    ex = tc.FxExecutor(vic["gm"], seq, prior, async_swap=async_swap)
    assert ex.current_op_index == -1
    ex.request_plan(newp, {sp.op_idx for sp in sps})
    out = ex.run(*vic["args"])
    assert ex.stats.hot_swaps == 1
    assert ex.plan is newp and ex.ctx.plan is newp
    assert ex.stats.swap_out_count > 0
    assert ex.current_op_index == len(seq.operators) - 1
    assert _equal(out, vic["unsched"])
    for a, b in zip(out, vic["ref"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)

    jseq = vic["jseq"]
    rprior = rc.SchedulingPlan(job_id="vic")
    rsps = rc.find_safe_points(jseq, rprior)
    rnew = _remainder(rc, jseq, REF_PROFILE, rprior, rsps[0].op_idx, 0.7)
    rex = rc.JaxprExecutor(vic["closed"], jseq, rprior)
    rex.request_plan(rnew, {sp.op_idx for sp in rsps})
    rex.run(*vic["jargs"])
    assert rex.stats.hot_swaps == ex.stats.hot_swaps
    assert rex.plan is rnew


def test_request_plan_never_fires_without_a_reachable_safe_point(vic):
    seq = vic["seq"]
    prior = tc.SchedulingPlan(job_id="vic")
    newp = _remainder(tc, seq, PROFILE, prior,
                      tc.find_safe_points(seq, prior)[0].op_idx, 0.7)
    for safe_ops in (set(), {len(seq.operators) + 5}):
        ex = tc.FxExecutor(vic["gm"], seq, prior)
        ex.request_plan(newp, safe_ops)
        out = ex.run(*vic["args"])
        assert ex.stats.hot_swaps == 0
        assert ex.plan is prior and ex.ctx.plan is prior
        assert _equal(out, vic["unsched"])


def test_hot_swap_cancels_a_queued_prefetch(vic):
    """A splice at an operator that has just queued a prefetch cancels it
    (it was never issued); its consumer swaps in passively, and the run
    still computes the unscheduled outputs."""
    seq = vic["seq"]
    plan = tc.schedule_single(seq, profile=PROFILE).plans["vic"]
    triggers = sorted(e.trigger_op for e in plan.events
                      if e.event_type is tc.EventType.SWAP_IN)
    assert triggers
    base = tc.FxExecutor(vic["gm"], seq, plan, async_swap=True)
    base.run(*vic["args"])
    ex = tc.FxExecutor(vic["gm"], seq, plan, async_swap=True)
    ex.request_plan(plan, {triggers[0]})
    out = ex.run(*vic["args"])
    assert ex.stats.hot_swaps == 1
    assert ex.stats.canceled_swap_ins >= 1
    assert ex.stats.passive_swap_ins >= base.stats.passive_swap_ins + 1
    assert _equal(out, vic["unsched"])


def test_cancel_unstarted_drops_queued_transfers_and_leaves_the_others():
    ax = AsyncSwapExecutor(tc.DmaChannel(), torch.device("cpu"))
    ran = []
    for key in ("in:a", "out:b", "in:c"):
        ax.submit(key, lambda key=key: ran.append(key))
    assert ax.cancel_unstarted("in:") == ["in:a", "in:c"]
    assert [t.key for t in ax.queue] == ["out:b"]
    assert set(ax.inflight) == {"out:b"}
    ax.flush()
    assert ran == ["out:b"]
    # an issued transfer that has landed is neither on the wire nor
    # cancellable: it waits for its consumer
    ax.submit("in:d", lambda: ran.append("in:d"))
    ax.flush()
    assert ax.cancel_unstarted("in:") == []
    assert "in:d" in ax.inflight and ran == ["out:b", "in:d"]


def test_cancel_unstarted_cancels_nothing_while_a_transfer_is_on_the_wire():
    class OnTheWire:                 # an event the copy stream has not reached
        def query(self):
            return False

    ax = AsyncSwapExecutor(tc.DmaChannel(), torch.device("cpu"))
    t = ax.submit("in:a", lambda: None)
    ax.flush()
    t.event = OnTheWire()
    ax.submit("in:b", lambda: None)
    assert ax.cancel_unstarted("in:") is None
    assert [q.key for q in ax.queue] == ["in:b"]
    assert set(ax.inflight) == {"in:a", "in:b"}
    assert ax.cancel_unstarted("out:") == []


# ---------------------------------------------------- controller preemption
def _victim_controller(mod, seq, profile, make_executor, **kw):
    """A controller with one running victim ``vic`` that holds its whole
    slice, then preempted to 0.7 of it (``test_hotswap.py``)."""
    gc = mod.GlobalController(profile=profile, async_swap=False,
                              pipeline_name="tensile+autoscale",
                              arbiter_policy="equal",
                              arbiter_mode="preempt", **kw)
    gc.scheduler.register_job(seq)
    gc.arbiter.register("vic", demand_bytes=0)
    prev = {"vic": mod.analyze([seq]).peak_bytes}
    gc.arbiter.last_assignment = dict(prev)
    handle = mod.JobHandle("vic", seq, None, (), 1)
    handle.executor = make_executor(gc)
    gc.jobs["vic"] = handle
    gc.accountant.alloc("vic", "resident-blob", prev["vic"])
    new_slice = int(prev["vic"] * 0.7)
    gc._preempt_victims({"vic": new_slice}, prev)
    return gc, handle, new_slice


def test_preempt_victims_matches_the_reference(vic):
    """On the reference's sequence the port's controller preempts the same
    victim with the same pending plan and budget."""
    jseq = vic["jseq"]
    rgc, rh, rslice = _victim_controller(
        rc, jseq, REF_PROFILE,
        lambda gc: rc.JaxprExecutor(vic["closed"], jseq, None,
                                    accountant=gc.accountant,
                                    channel=gc.channel))
    pgc, ph, pslice = _victim_controller(
        tc, to_port(jseq), PROFILE,
        lambda gc: tc.FxExecutor(vic["gm"], vic["seq"], None,
                                 accountant=gc.accountant,
                                 channel=gc.channel), device="cpu")
    assert pgc.preempt_count == rgc.preempt_count == 1
    assert ph.preemptions == rh.preemptions
    assert not pgc.preempt_failures and not rgc.preempt_failures
    pplan, psafe = ph.executor._pending_plan
    rplan, rsafe = rh.executor._pending_plan
    assert pslice == rslice and pplan.budget_bytes == rplan.budget_bytes \
        == pslice
    assert psafe == rsafe
    assert _plain(pplan.to_dict()) == _plain(rplan.to_dict())


def test_controller_preempts_running_victim(vic):
    """The controller's path on the port's own capture: the shrunken slice
    goes through ``replan_from`` into the victim's executor, which applies
    it at a safe point with its outputs intact."""
    seq = vic["seq"]
    gc, handle, new_slice = _victim_controller(
        tc, seq, PROFILE,
        lambda gc: tc.FxExecutor(vic["gm"], seq, None,
                                 accountant=gc.accountant,
                                 channel=gc.channel), device="cpu")
    assert gc.preempt_count == 1 and handle.preemptions
    ex = handle.executor
    plan, _ = ex._pending_plan
    assert plan.budget_bytes == new_slice
    assert plan.provenance[-1]["action"] == "replan_from"
    out = ex.run(*vic["args"])
    assert ex.stats.hot_swaps == 1 and ex.plan is plan
    assert _equal(out, vic["unsched"])
    for a, b in zip(out, vic["ref"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)


# ------------------------------------------------ the controller end to end
SMALL, LARGE = ((32, 64, 64, 4), 8), ((64, 256, 256, 8), 16)


def _solo(sizes, batch, seed, job_id):
    """A job's payload, its unscheduled ledger peak, the bytes it holds at
    an iteration's end (its state) and its no-free peak."""
    payload = make_mlp(sizes, batch, seed=seed, device="cpu")
    seq, gm = tc.capture_train_step(*payload, job_id=job_id,
                                    cost_model=tc.CostModel(CALIB))
    ex = tc.FxExecutor(gm, seq, None)
    ex.run(*payload[1:])
    return dict(payload=payload, peak=ex.accountant.peak,
                state=ex.accountant.job_bytes(job_id),
                demand=tc.analyze([seq], free_at_last_use=False).peak_bytes)


@pytest.mark.parametrize("mode", ["boundary", "preempt"])
def test_two_staggered_jobs_finish_within_the_capacity(mode):
    """A small job and a large one, staggered, on one shared ledger under
    the priority policy (3:1): the small one's slice is its whole demand,
    the large one's a cut below its unscheduled peak.  The capacity is the
    small job's state plus the large job's unscheduled peak, so every
    phase fits it (alone, together, and after either leaves with its state
    still on the device) when each plan keeps to its slice."""
    j0 = _solo(*SMALL, seed=0, job_id="j0")
    j1 = _solo(*LARGE, seed=1, job_id="j1")
    cap = j0["state"] + j1["peak"]
    gc = tc.GlobalController(profile=PROFILE, async_swap=True,
                             pipeline_name="tensile+autoscale",
                             arbiter_policy="priority", arbiter_mode=mode,
                             device_capacity=cap, device="cpu",
                             cost_model=tc.CostModel(CALIB))
    caps = [gc.capture_spec(JobSpec("j1", iterations=2, priority=1.0,
                                    payload=j1["payload"]))]
    h0 = gc.submit(JobSpec("j0", iterations=3, priority=3.0,
                           payload=j0["payload"]))
    h1 = gc.submit(JobSpec("j1", iterations=2, priority=1.0,
                           payload=j1["payload"]), caps[0])
    gc.wait(timeout=300)
    assert all(h.done and h.error is None for h in gc.jobs.values())
    assert not gc.preempt_failures and not gc.replan_failures
    assert len(h0.step_times) == 3 and len(h1.step_times) == 2
    both = [s for s in gc.arbiter.history if set(s) == {"j0", "j1"}]
    assert both and both[0]["j1"] < j1["peak"] <= cap
    assert all(sum(s.values()) <= cap for s in gc.arbiter.history)
    assert gc.global_peak_bytes <= cap
    assert gc.accountant.oom_events == 0
    for h in (h0, h1):
        assert h.ledger_view is not None
        assert h.ledger_view.peak == gc.accountant.job_peak(h.job_id)
    # the final state is the unscheduled runs' bit for bit
    for job, h, n in ((j0, h0, 3), (j1, h1, 2)):
        step, params, opt, batch = make_mlp(
            *(SMALL if h is h0 else LARGE), seed=0 if h is h0 else 1,
            device="cpu")
        seq, gm = tc.capture_train_step(step, params, opt, batch)
        state = [params, opt, batch]
        for _ in range(n):
            outs = tc.FxExecutor(gm, seq, None).run(*state)
            state = list(torch.utils._pytree.tree_unflatten(
                outs[:len(torch.utils._pytree.tree_leaves(state[:2]))],
                torch.utils._pytree.tree_structure(state[:2]))) + [batch]
        assert _equal(torch.utils._pytree.tree_leaves(h.args[:2]),
                      torch.utils._pytree.tree_leaves(state[:2]))


def _one_job_over_its_plan(monkeypatch, **kw):
    """One job alone at 0.6 of its unscheduled peak, a slice its plan does
    not reach, under a controller built with ``kw``: the handle, the
    controller, the capacity, and the budget each executor was given.
    The final state must be the unscheduled runs' bit for bit."""
    j1 = _solo(*LARGE, seed=1, job_id="j1")
    cap = int(0.6 * j1["peak"])
    budgets = []
    init = tc.FxExecutor.__init__

    def spy(self, *a, **kw):
        budgets.append(kw.get("budget_bytes"))
        init(self, *a, **kw)

    monkeypatch.setattr(tc.FxExecutor, "__init__", spy)
    gc = tc.GlobalController(profile=PROFILE, async_swap=True,
                             pipeline_name="tensile+autoscale",
                             arbiter_policy="equal", device_capacity=cap,
                             device="cpu", cost_model=tc.CostModel(CALIB),
                             **kw)
    h = gc.submit(JobSpec("j1", iterations=2, payload=j1["payload"]))
    gc.wait(timeout=300)
    assert h.done and h.error is None
    assert h.plan.planned_peak_bytes > cap
    given = list(budgets)
    step, params, opt, batch = make_mlp(*LARGE, seed=1, device="cpu")
    seq, gm = tc.capture_train_step(step, params, opt, batch)
    state = [params, opt, batch]
    for _ in range(2):
        outs = tc.FxExecutor(gm, seq, None).run(*state)
        state = list(torch.utils._pytree.tree_unflatten(
            outs[:len(torch.utils._pytree.tree_leaves(state[:2]))],
            torch.utils._pytree.tree_structure(state[:2]))) + [batch]
    assert _equal(torch.utils._pytree.tree_leaves(h.args[:2]),
                  torch.utils._pytree.tree_leaves(state[:2]))
    return h, gc, cap, given


def test_a_job_holds_its_slice_when_its_plan_cannot(monkeypatch):
    """With ``hold_slices``, each executor is given the job's slice
    (``FxExecutor(budget_bytes=...)``) and swaps out more itself, so the
    ledger stays within the capacity."""
    h, gc, cap, budgets = _one_job_over_its_plan(monkeypatch,
                                                 hold_slices=True)
    assert budgets == [cap, cap]
    assert sum(st.budget_evictions for st in h.stats) > 0
    assert gc.global_peak_bytes <= cap


def test_by_default_a_job_runs_its_plan_as_planned(monkeypatch):
    """Without ``hold_slices`` (the default, as the reference's
    controller) no executor is given a budget: the job runs the plan it
    was given, over the capacity, and swaps out nothing of its own."""
    h, gc, cap, budgets = _one_job_over_its_plan(monkeypatch)
    assert budgets == [None, None]
    assert sum(st.budget_evictions + st.budget_waits for st in h.stats) == 0
    assert gc.global_peak_bytes > cap


def test_a_held_slice_shrinks_in_the_running_iteration(monkeypatch):
    """With ``hold_slices``, an arrival that shrinks a running job's slice
    reaches that job's executor at once: the iteration planned for the
    whole capacity is held to the smaller slice, so the two jobs stay
    within the capacity.  The first job is held before its first operator
    until the second is submitted (no timing decides the order)."""
    started, go = threading.Event(), threading.Event()
    run = tc.FxExecutor.run_donated

    def held(self, args):
        if self.seq.job_id == "x" and not go.is_set():
            started.set()
            go.wait(60)
        return run(self, args)

    monkeypatch.setattr(tc.FxExecutor, "run_donated", held)
    x = _solo(*LARGE, seed=1, job_id="x")
    cap = x["peak"]
    gc = tc.GlobalController(profile=PROFILE, async_swap=True,
                             pipeline_name="tensile+autoscale",
                             arbiter_policy="priority", device_capacity=cap,
                             device="cpu", cost_model=tc.CostModel(CALIB),
                             hold_slices=True)
    spec_y = JobSpec("y", iterations=1, priority=1.0,
                     payload=make_mlp(*SMALL, device="cpu"))
    cap_y = gc.capture_spec(spec_y)
    hx = gc.submit(JobSpec("x", iterations=1, priority=3.0,
                           payload=x["payload"]))
    try:
        assert started.wait(60)
        ex = hx.executor
        assert ex.budget_bytes == hx.budget_bytes == cap
        gc.submit(spec_y, cap_y)
        assert hx.budget_bytes == gc.arbiter.last_assignment["x"] < cap
        assert ex.budget_bytes == hx.budget_bytes
    finally:
        go.set()
        gc.wait(timeout=300)
    assert gc.global_peak_bytes <= cap
    step, params, opt, batch = make_mlp(*LARGE, seed=1, device="cpu")
    seq, gm = tc.capture_train_step(step, params, opt, batch)
    outs = tc.FxExecutor(gm, seq, None).run(params, opt, batch)
    n = len(torch.utils._pytree.tree_leaves(hx.args[:2]))
    assert _equal(torch.utils._pytree.tree_leaves(hx.args[:2]), outs[:n])


def test_a_held_slice_below_an_operator_still_finishes_the_iteration(
        monkeypatch):
    """An arrival whose split leaves a running job less than one of its
    operators must hold at once: the running executor's guard takes the
    operator floor instead of the slice, and the job finishes its
    iteration with the values of its unscheduled run (with the slice
    itself the guard raised ``BudgetExceededError`` at its first
    booking).  The first job is held before its first operator until the
    second is submitted."""
    started, go = threading.Event(), threading.Event()
    run = tc.FxExecutor.run_donated

    def held(self, args):
        if self.seq.job_id == "x" and not go.is_set():
            started.set()
            go.wait(60)
        return run(self, args)

    monkeypatch.setattr(tc.FxExecutor, "run_donated", held)
    x = _solo(*LARGE, seed=1, job_id="x")
    cap = x["peak"]
    gc = tc.GlobalController(profile=PROFILE, async_swap=True,
                             pipeline_name="tensile+autoscale",
                             arbiter_policy="priority", device_capacity=cap,
                             device="cpu", cost_model=tc.CostModel(CALIB),
                             hold_slices=True)
    spec_y = JobSpec("y", iterations=1, priority=1000.0,
                     payload=make_mlp(*LARGE, seed=2, device="cpu"))
    cap_y = gc.capture_spec(spec_y)
    hx = gc.submit(JobSpec("x", iterations=1, priority=1.0,
                           payload=x["payload"]))
    try:
        assert started.wait(60)
        ex = hx.executor
        gc.submit(spec_y, cap_y)
        floor = ex.operator_floor()
        assert hx.budget_bytes == gc.arbiter.last_assignment["x"] < floor
        assert ex.budget_bytes == floor < cap
    finally:
        go.set()
        gc.wait(timeout=300)
    assert not hx.error and gc.jobs["y"].error is None
    step, params, opt, batch = make_mlp(*LARGE, seed=1, device="cpu")
    seq, gm = tc.capture_train_step(step, params, opt, batch)
    outs = tc.FxExecutor(gm, seq, None).run(params, opt, batch)
    n = len(torch.utils._pytree.tree_leaves(hx.args[:2]))
    assert _equal(torch.utils._pytree.tree_leaves(hx.args[:2]), outs[:n])


def test_job_thread_failure_surfaces_through_wait(monkeypatch):
    def boom(self, *args, **kwargs):
        raise RuntimeError("executor exploded")

    monkeypatch.setattr(tc.FxExecutor, "run_donated", boom)
    gc = tc.GlobalController(profile=PROFILE, async_swap=False, device="cpu")
    gc.submit(JobSpec("doomed", iterations=1,
                      payload=make_mlp(*SMALL, device="cpu")))
    with pytest.raises(tc.JobFailedError) as ei:
        gc.wait(timeout=120)
    err = ei.value
    assert "doomed" in str(err) and "executor exploded" in str(err)
    assert isinstance(err.failures["doomed"], RuntimeError)
    assert isinstance(err.__cause__, RuntimeError)
    assert "RuntimeError" in err.tracebacks["doomed"]
    assert gc.failures() and gc.jobs["doomed"].error_tb
    gc.wait(timeout=1, raise_errors=False)


def test_controller_refuses_a_payload_off_its_device(monkeypatch):
    """The default device is the card; a CPU payload is refused, never run
    there instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    gc = tc.GlobalController(profile=PROFILE)
    assert gc.device.type == "cuda"
    with pytest.raises(ValueError, match="controller runs on cuda"):
        gc.capture_spec(JobSpec("j", payload=make_mlp(*SMALL,
                                                      device="cpu")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.GlobalController(profile=PROFILE)


@pytest.mark.parametrize("kw", [{"experience": "store"},
                                {"experience_dir": "store"},
                                {"drift": "monitor"}])
def test_unported_hooks_are_refused(kw, tmp_path):
    """The three hooks the controller refused until the experience plane
    and the drift monitor were ported (the name is kept): each is now
    accepted and does its work on a small job.  A store, given or made
    from a directory, gets the job's distilled run at exit and answers
    ``predict_peak`` with its measured peak; a monitor gets one sample
    comparing the admission-time prediction with that peak."""
    from repro_torch.obs import DriftMonitor
    (hook, _), = kw.items()
    root = str(tmp_path / "store")
    arg = {"experience": lambda: tc.ExperienceStore(
               root, device_id=tc.device_identity(PROFILE)),
           "experience_dir": lambda: root,
           "drift": DriftMonitor}[hook]()
    gc = tc.GlobalController(profile=PROFILE, async_swap=False,
                             device="cpu", **{hook: arg})
    spec = JobSpec("j", iterations=1, payload=make_mlp(*SMALL, device="cpu"))
    cap = gc.capture_spec(spec)
    h = gc.submit(spec, cap)
    gc.wait(timeout=120)
    assert h.done and h.error is None
    measured = max(h.peak_bytes, gc.accountant.job_peak("j"))
    if hook == "drift":
        assert gc.experience is None and h.fingerprint is None
        sample = arg.last("j")
        assert (sample.predicted_peak, sample.measured_peak) \
            == (h.predicted_peak, measured)
        assert h.predicted_peak == gc.predict_peak(cap.seq)[0]
        return
    store = gc.experience
    assert store is arg or store.root == os.path.abspath(root)
    assert store.fingerprints() == [h.fingerprint]
    assert gc.predict_peak(cap.seq) == (measured, "experience")
    assert store.device_calibration() == gc.cost_model.calib
    assert not gc.experience_failures


def test_serve_job_under_the_controller_keeps_the_golden_tokens(monkeypatch):
    """A reduced TinyLlama serve job on the CPU under a slice of about half
    its KV demand evicts and still generates the unbudgeted run's tokens."""
    sp = ServeParams(max_sequences=4, n_requests=6, prompt_len=8,
                     gen_len=8, trace="burst", block_tokens=4)
    monkeypatch.setitem(
        workloads._SERVE_REGISTRY, "lm-cpu",
        lambda p: workloads.make_lm_serving(p, device="cpu"))
    golden_engine, reqs = workloads.make_lm_serving(sp, device="cpu")
    _, golden = golden_engine.serve(reqs, budget_bytes=None, schedule=False)
    cap = golden_engine.bytes_per_token * 2 * (sp.prompt_len + sp.gen_len)
    gc = tc.GlobalController(profile=PROFILE, arbiter_policy="peak",
                             device_capacity=cap, device="cpu")
    spec = JobSpec("serve", kind="serve", workload="lm-cpu", serve=sp)
    captured = gc.capture_spec(spec)
    assert gc.predict_peak(captured.seq) == (2 * cap, "cost-model")
    h = gc.submit(spec, captured)
    gc.wait(timeout=300)
    assert h.done and h.error is None
    assert h.budget_bytes == cap
    rep = h.stats[-1]
    assert rep.oom_events == 0 and rep.evictions > 0
    assert h.outputs == golden
    assert gc.global_peak_bytes <= cap


def test_example_runs_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["multi_workload_torch.py",
                                      "--device", "cpu"])
    runpy.run_path(os.path.join(ROOT, "examples", "multi_workload_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "all jobs done" in out


# -------------------------------------------------------------- the copies
def _spec_kwargs(mod, kind):
    kw = dict(job_id="j", kind=kind, workload_params={"size": "small"},
              priority=2.0, iterations=3, budget_hint_bytes=1 << 20,
              offset_frac=0.5, fingerprint="fp", schedule=False)
    if kind == "serve":
        kw["serve"] = mod.ServeParams(max_sequences=2, n_requests=4,
                                      trace="poisson", seed=3)
        kw["workload"] = "lm"
    else:
        kw["workload"] = "mlp"
    return kw


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_jobspec_round_trips_like_the_reference(kind):
    port = JobSpec(**_spec_kwargs(jobspec, kind))
    ref = ref_jobspec.JobSpec(**_spec_kwargs(ref_jobspec, kind))
    assert port.to_dict() == ref.to_dict()
    assert JobSpec.from_dict(port.to_dict()) == port
    assert JobSpec.from_dict(ref.to_dict()) == port
    assert jobspec.SPEC_SCHEMA_VERSION == ref_jobspec.SPEC_SCHEMA_VERSION
    if kind == "serve":
        wire = dict(port.to_dict(), serve=port.serve.to_dict())
        assert JobSpec(**{k: v for k, v in wire.items()
                          if k != "schema"}).serve == port.serve
        assert ServeParams.from_dict(port.serve.to_dict()) == port.serve
        assert JobSpec("s", kind="serve").serve == ServeParams()
    assert [(s.value, s.terminal) for s in jobspec.JobState] == \
        [(s.value, s.terminal) for s in ref_jobspec.JobState]


@pytest.mark.parametrize("bad", [
    {"job_id": ""}, {"kind": "batch"}, {"serve": {}},
    {"iterations": 0}, {"priority": 0.0}, {"budget_hint_bytes": 0},
    {"payload": (1, 2, 3)}])
def test_jobspec_rejects_like_the_reference(bad):
    for mod in (jobspec, ref_jobspec):
        kw = dict(dict(job_id="j"), **bad)
        if "serve" in bad:
            kw["serve"] = mod.ServeParams()
        with pytest.raises(ValueError):
            mod.JobSpec(**kw)


def test_wire_forms_reject_like_the_reference():
    for mod in (jobspec, ref_jobspec):
        for data in ("x", {"schema": 9, "job_id": "j"}, {"kind": "train"}):
            with pytest.raises(ValueError):
                mod.JobSpec.from_dict(data)
        with pytest.raises(ValueError):
            mod.ServeParams(max_sequences=0)
        with pytest.raises(ValueError):
            mod.ServeParams.from_dict(["x"])
        assert mod.JobSpec.from_dict(
            {"job_id": "j", "schema": 1, "unknown": 1}).job_id == "j"


def _reference_registry_as_built(monkeypatch):
    """The reference's workload registry reduced to the entries its module
    registers itself (read off a fresh copy of the module), for this
    test: ``tests/test_service.py`` registers a name for good, and a
    worker that ran it first would see that name too."""
    spec = importlib.util.find_spec(ref_workloads.__name__)
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    monkeypatch.setattr(ref_workloads, "_REGISTRY", {
        k: ref_workloads._REGISTRY[k] for k in fresh._REGISTRY})


def test_resolve_workload_after_a_reference_registration(monkeypatch):
    """A name registered in the reference's registry before (as
    ``tests/test_service.py`` registers ``"svc-test"``) does not fail
    ``test_resolve_workload_like_the_reference``."""
    monkeypatch.setitem(ref_workloads._REGISTRY, "svc-test", make_mlp)
    assert "svc-test" in ref_workloads.registered_workloads()
    test_resolve_workload_like_the_reference(monkeypatch)


def test_resolve_workload_like_the_reference(monkeypatch):
    _reference_registry_as_built(monkeypatch)
    assert workloads.registered_workloads() == \
        ref_workloads.registered_workloads() == ("mlp",)
    port = workloads.resolve_workload(JobSpec(
        "j", workload="mlp", workload_params={"size": "small",
                                              "device": "cpu"}))
    ref = ref_workloads.resolve_workload(ref_jobspec.JobSpec(
        "j", workload="mlp", workload_params={"size": "small"}))
    shapes = [tuple(x.shape) for x in jax.tree.leaves(ref[1])]
    assert [tuple(x.shape) for x in
            torch.utils._pytree.tree_leaves(port[1])] == shapes
    via_import = workloads.resolve_workload(JobSpec(
        "j", workload="repro_torch.service.workloads:make_mlp",
        workload_params={"size": "small", "device": "cpu"}))
    assert _equal(torch.utils._pytree.tree_leaves(via_import[1]),
                  torch.utils._pytree.tree_leaves(port[1]))
    payload = object(), 1, 2, 3
    assert workloads.resolve_workload(JobSpec(
        "j", workload="mlp", payload=payload)) is payload
    for mod, spec_mod in ((workloads, jobspec),
                          (ref_workloads, ref_jobspec)):
        for kw, match in (({}, "neither payload nor workload"),
                          ({"workload": "nope"}, "unknown workload"),
                          ({"workload": "no_such_mod:f"}, "cannot import")):
            with pytest.raises(ValueError, match=match):
                mod.resolve_workload(spec_mod.JobSpec("j", **kw))
        for name in ("", "a:b"):
            with pytest.raises(ValueError):
                mod.register_workload(name, make_mlp)
    monkeypatch.setitem(workloads._REGISTRY, "tiny",
                        lambda device="cpu": make_mlp(*SMALL, device=device))
    assert workloads.registered_workloads() == ("mlp", "tiny")
    assert len(workloads.resolve_workload(JobSpec("j", workload="tiny"))) \
        == 4


def test_resolve_serve_workload_like_the_reference(monkeypatch):
    assert workloads.registered_serve_workloads() == \
        ref_workloads.registered_serve_workloads() == ("lm",)
    for mod, spec_mod in ((workloads, jobspec),
                          (ref_workloads, ref_jobspec)):
        with pytest.raises(ValueError, match="not a serve spec"):
            mod.resolve_serve_workload(spec_mod.JobSpec("j"))
        for name, match in (("nope", "unknown serve workload"),
                            ("no_such_mod:f", "cannot import")):
            with pytest.raises(ValueError, match=match):
                mod.resolve_serve_workload(spec_mod.JobSpec(
                    "j", kind="serve", workload=name))
        with pytest.raises(ValueError):
            mod.register_serve_workload("a:b", lambda sp: None)
    sp = dict(max_sequences=2, n_requests=5, prompt_len=4, gen_len=4,
              trace="poisson", seed=2)
    monkeypatch.setitem(
        workloads._SERVE_REGISTRY, "lm",
        lambda p: workloads.make_lm_serving(p, device="cpu"))
    engine, reqs = workloads.resolve_serve_workload(
        JobSpec("j", kind="serve", serve=ServeParams(**sp)))
    ref_engine, ref_reqs = ref_workloads.resolve_serve_workload(
        ref_jobspec.JobSpec("j", kind="serve",
                            serve=ref_jobspec.ServeParams(**sp)))
    assert engine.device == torch.device("cpu")
    assert engine.bytes_per_token == ref_engine.bytes_per_token
    assert [dataclasses.astuple(r) for r in reqs] == \
        [dataclasses.astuple(r) for r in ref_reqs]


def test_event_log_matches_the_reference():
    class Recorder:
        def __init__(self):
            self.calls = []

        def instant(self, name, t, **kw):
            self.calls.append((name, t, sorted(kw.items())))

    logs = []
    for cls in (EventLog, RefEventLog):
        ticks = iter(range(100))
        log = cls(maxlen=3, clock=lambda: next(ticks))
        rec = Recorder()
        log.attach_recorder(rec)
        log.info("replan", "split", job_id="a", n=2)
        log.warn("preempt", "replan failed", job_id="b", error="x")
        log.error("replan", "down")
        log.emit("DEBUG", "engine", "tick", k=1)
        with pytest.raises(AssertionError):
            log.emit("LOUD", "engine", "no such level")
        logs.append(([e.to_dict() for e in log.events()],
                     [e.to_dict() for e in log.events(level="WARN")],
                     [e.to_dict() for e in log.events(source="replan")],
                     [e.to_dict() for e in log.warnings()],
                     len(log), log.dropped, rec.calls))
    assert logs[0] == logs[1]
    assert logs[0][4] == 3 and logs[0][5] == 1


def test_many_jobs_under_a_short_switch_interval_keep_the_ledger_whole():
    """More job threads than the cores they may run on, switching every
    microsecond, on one shared ledger and arbiter: every iteration runs,
    and the ledger's per-job bytes still add up to its total (a lost
    update would break that)."""
    n_jobs = (os.cpu_count() or 4) + 2
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        gc = tc.GlobalController(profile=PROFILE, async_swap=True,
                                 pipeline_name="tensile+autoscale",
                                 arbiter_policy="equal",
                                 arbiter_mode="preempt",
                                 device_capacity=n_jobs * 100_000,
                                 device="cpu")
        for j in range(n_jobs):
            gc.submit(JobSpec(f"j{j}", iterations=2,
                              payload=make_mlp(*SMALL, seed=j,
                                               device="cpu")))
        gc.wait(timeout=300)
    finally:
        sys.setswitchinterval(prev)
    assert all(h.done and not h.thread.is_alive() and h.error is None
               and len(h.step_times) == 2 for h in gc.jobs.values())
    led = gc.accountant
    assert sum(led.job_bytes(j) for j in gc.jobs) == led.used
    assert not gc.replan_failures and not gc.preempt_failures
    assert all(sum(s.values()) <= gc.arbiter.capacity
               for s in gc.arbiter.history)
