"""The port's planner copies (``repro_torch.core``: access, plan, peak
analysis, swap and recompute planners, passes, scheduler, simulator,
baselines, engine) against the JAX package's on the same sequences.

Sequences are built by the reference (``tests/helpers.py``: the synthetic
chain, and the MLP captured from its jaxpr) and converted field by field
into the port's ``AccessSequence``; machine profiles are copied field by
field too, since the two packages' defaults describe different machines
(TPU v5e, H100).  The planner is the same Python arithmetic on the same
inputs, so every comparison is exact: the golden plans of
``tests/golden/seed_plans.json``, peak reports, simulated results and
decision traces.
"""
import dataclasses
import json
import os

import pytest

import repro.core as rc
from golden_cases import MLP_PROFILE, PROFILE, fp_plan
from helpers import capture_mlp, synthetic_chain
import repro_torch.core as tc
from repro_torch.core import access as ta

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "seed_plans.json")


def to_port(seq: rc.AccessSequence) -> tc.AccessSequence:
    """The reference's sequence as the port's, field by field."""
    ops = [ta.Operator(idx=o.idx, name=o.name, inputs=tuple(o.inputs),
                       outputs=tuple(o.outputs), latency=o.latency,
                       flops=o.flops, bytes_accessed=o.bytes_accessed,
                       phase=ta.Phase(o.phase.value), params=dict(o.params),
                       job_id=o.job_id)
           for o in seq.operators]
    tensors = {tid: ta.TensorSpec(tid=t.tid, size_bytes=t.size_bytes,
                                  shape=tuple(t.shape), dtype=t.dtype,
                                  kind=ta.TensorKind(t.kind.value),
                                  job_id=t.job_id, updates=t.updates)
               for tid, t in seq.tensors.items()}
    return ta.AccessSequence(seq.job_id, ops, tensors,
                             initial_resident=list(seq.initial_resident))


def port_profile(p: rc.MachineProfile) -> tc.MachineProfile:
    """Every field of the port's profile set from the reference's."""
    return tc.MachineProfile(**{f.name: getattr(p, f.name)
                                for f in dataclasses.fields(tc.MachineProfile)})


def chain(**kw):
    seq = synthetic_chain(**kw)
    return seq, to_port(seq)


@pytest.fixture(scope="module")
def mlp():
    seq, _, _ = capture_mlp(sizes=(64, 128, 128, 8), batch=16)
    return seq, to_port(seq)


# ------------------------------------------------------------- goldens
def port_goldens(mlp_pair) -> dict:
    """``golden_cases.regenerate`` through the port's planner."""
    out: dict = {}
    prof = port_profile(PROFILE)
    _, seq = chain(n_ops=12, latency=2.0, seed=0)
    res = tc.schedule_single(seq, profile=prof)
    out["tensile_chain"] = {
        "plan": fp_plan(res.plans[seq.job_id]),
        "initial_peak": res.initial_report.peak_bytes,
        "final_peak": res.final_report.peak_bytes,
        "iterations": res.iterations,
        "swaps": res.swaps_scheduled,
        "recomputes": res.recomputes_scheduled,
    }
    out["vdnn_chain"] = {"plan": fp_plan(tc.vdnn_conv_plan(seq, prof))}
    out["capuchin_chain"] = {
        "plan": fp_plan(tc.capuchin_plan(seq, budget_bytes=50_000,
                                         profile=prof).plan)}

    tight = port_profile(rc.MachineProfile(
        host_link_bw=1.0, host_link_latency=100.0, compute_flops=1e9,
        mem_bw=1e9))
    _, seq9 = chain(n_ops=10, latency=1.0, seed=9)
    sched = tc.MemoryScheduler(tight, tc.SchedulerConfig(
        memory_budget_bytes=1))
    sched.register_job(seq9)
    res9 = sched.schedule()
    out["tensile_recompute_chain"] = {
        "plan": fp_plan(res9.plans[seq9.job_id]),
        "final_peak": res9.final_report.peak_bytes,
        "swaps": res9.swaps_scheduled,
        "recomputes": res9.recomputes_scheduled,
    }

    _, a = chain(n_ops=8, latency=2.0, job_id="a", seed=1)
    _, b = chain(n_ops=8, latency=2.0, job_id="b", seed=2)
    ms = tc.MemoryScheduler(prof, tc.SchedulerConfig(max_swap_ratio=0.5))
    ms.register_job(a)
    ms.register_job(b, offset=3.0)
    resm = ms.schedule()
    out["tensile_multi"] = {
        "plans": {j: fp_plan(resm.plans[j]) for j in ("a", "b")},
        "final_peak": resm.final_report.peak_bytes,
        "swaps": resm.swaps_scheduled,
        "recomputes": resm.recomputes_scheduled,
    }

    mprof = port_profile(MLP_PROFILE)
    mseq = mlp_pair[1]
    mres = tc.schedule_single(mseq, profile=mprof)
    out["tensile_mlp"] = {
        "plan": fp_plan(mres.plans[mseq.job_id]),
        "final_peak": mres.final_report.peak_bytes,
        "swaps": mres.swaps_scheduled,
        "recomputes": mres.recomputes_scheduled,
    }
    out["vdnn_mlp"] = {"plan": fp_plan(tc.vdnn_conv_plan(mseq, mprof))}
    cap = tc.capuchin_plan(mseq, budget_bytes=10_000, profile=mprof)
    out["capuchin_mlp"] = {"plan": fp_plan(cap.plan),
                           "passive_iterations": cap.passive_iterations}
    cap2 = tc.capuchin_plan(mseq, budget_bytes=mres.final_report.peak_bytes,
                            profile=mprof)
    out["capuchin_mlp_tensile_budget"] = {"plan": fp_plan(cap2.plan)}
    return out


@pytest.fixture(scope="module")
def goldens(mlp):
    with open(GOLDEN) as f:
        gold = json.load(f)
    return gold, json.loads(json.dumps(port_goldens(mlp)))


@pytest.mark.parametrize("case", [
    "tensile_chain", "vdnn_chain", "capuchin_chain",
    "tensile_recompute_chain", "tensile_multi", "tensile_mlp", "vdnn_mlp",
    "capuchin_mlp", "capuchin_mlp_tensile_budget"])
def test_port_reproduces_golden_plans(goldens, case):
    gold, mine = goldens
    assert mine[case] == gold[case]


def test_goldens_cover_the_golden_file(goldens):
    gold, mine = goldens
    assert set(mine) == set(gold)


# ------------------------------------------------------ peaks and sims
PIPELINES = sorted(rc.PIPELINES)


def test_pipeline_registries_match():
    assert sorted(tc.PIPELINES) == PIPELINES


def _pair(which, mlp):
    if which == "mlp":
        return mlp[0], mlp[1], MLP_PROFILE
    ref, port = chain(n_ops=12, latency=2.0, seed=0)
    return ref, port, PROFILE


@pytest.mark.parametrize("which", ["chain", "mlp"])
def test_peak_reports_match(mlp, which):
    ref, port, prof = _pair(which, mlp)
    res_r = rc.schedule_single(ref, profile=prof)
    res_p = tc.schedule_single(port, profile=port_profile(prof))
    for plans_r, plans_p in ((None, None), (res_r.plans, res_p.plans)):
        a = rc.analyze([ref], plans=plans_r)
        b = tc.analyze([port], plans=plans_p)
        assert (a.peak_bytes, a.peak_time) == (b.peak_bytes, b.peak_time)
        assert a.peak_tensors == b.peak_tensors
        assert rc.vanilla_peak(ref) == tc.vanilla_peak(port)


@pytest.mark.parametrize("name", PIPELINES)
@pytest.mark.parametrize("which", ["chain", "mlp"])
def test_pipelines_plan_simulate_and_evaluate_alike(mlp, which, name):
    ref, port, prof = _pair(which, mlp)
    pprof = port_profile(prof)
    budget = rc.analyze([ref]).peak_bytes // 2
    res_r = rc.build_pipeline(name, prof, rc.SchedulerConfig(
        memory_budget_bytes=budget)).plan([ref])
    res_p = tc.build_pipeline(name, pprof, tc.SchedulerConfig(
        memory_budget_bytes=budget)).plan([port])
    plan_r, plan_p = res_r.plans[ref.job_id], res_p.plans[port.job_id]
    assert fp_plan(plan_r) == fp_plan(plan_p)
    assert res_r.final_report.peak_bytes == res_p.final_report.peak_bytes
    for mode in ("sync", "async"):
        eng_r, eng_p = rc.MemoryEngine(prof, trace=True), \
            tc.MemoryEngine(pprof, trace=True)
        sim_r = rc.simulate([ref], {ref.job_id: plan_r}, prof, iterations=2,
                            transfer_mode=mode, engine=eng_r)
        sim_p = tc.simulate([port], {port.job_id: plan_p}, pprof,
                            iterations=2, transfer_mode=mode, engine=eng_p)
        assert (sim_r.peak_bytes, sim_r.total_time, sim_r.stall_time,
                sim_r.passive_swap_ins) == (sim_p.peak_bytes,
                                            sim_p.total_time,
                                            sim_p.stall_time,
                                            sim_p.passive_swap_ins)
        assert eng_r.trace.keys() == eng_p.trace.keys()
    assert rc.evaluate([ref], res_r.plans, prof) == \
        tc.evaluate([port], res_p.plans, pprof)


def test_safe_points_match(mlp):
    ref, port, prof = _pair("mlp", mlp)
    plan_r = rc.schedule_single(ref, profile=prof).plans[ref.job_id]
    plan_p = tc.schedule_single(port, profile=port_profile(prof)).plans[
        port.job_id]
    assert [dataclasses.astuple(s) for s in rc.find_safe_points(ref, plan_r)] \
        == [dataclasses.astuple(s) for s in tc.find_safe_points(port, plan_p)]


def test_plan_round_trips_through_dict(mlp):
    port = mlp[1]
    plan = tc.schedule_single(port, profile=port_profile(MLP_PROFILE)).plans[
        port.job_id]
    again = tc.SchedulingPlan.from_dict(plan.to_dict())
    assert fp_plan(again) == fp_plan(plan)


def test_profile_fields_are_the_references():
    """The port's profile has the reference's fields, ``ici_bw`` among
    them, and no other."""
    assert {f.name for f in dataclasses.fields(tc.MachineProfile)} == {
        f.name for f in dataclasses.fields(rc.MachineProfile)}


def test_h100_profile_defaults():
    """The port's defaults describe one H100 SXM; the reference's a TPU."""
    p = tc.MachineProfile()
    assert p.device_memory_bytes == 80 * 10 ** 9
    assert (p.compute_flops, p.mem_bw) == (989e12, 3.35e12)
    assert p.ici_bw == 25e9                 # NVLink 4 per link and direction
    assert p.transfer_time(1 << 20, compressed=True) < p.transfer_time(
        1 << 20)
