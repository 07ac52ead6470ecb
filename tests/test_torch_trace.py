"""The port's trace recorder (``repro_torch.obs.trace``) and
``tools/tensile_trace_torch.py`` against the JAX package's, on the CPU.

The recorder is a copy of the reference's and reads the port hub's sample
schemas (``core/telemetry.py``), whose fields are the reference's: a
simulator run of the same plan must render the same Chrome trace JSON in
both packages, event for event.  A real run of the port's MLP through
``FxExecutor`` must render the simulator's schema (the reference's
``test_sim_and_real_traces_share_schema``); the op spans carry aten names
where the reference's carry JAX primitives, so names are compared within
the port only.  The other cases are the reference's trace cases of
``tests/test_obs.py`` on the port.
"""
import json
import os
import subprocess
import sys

import pytest

import repro.core as rc
from repro.obs import EventLog as RefEventLog
from repro.obs import TraceRecorder as RefTraceRecorder
from helpers import synthetic_chain
import repro_torch.core as tc
from repro_torch.obs import (DMA_TID, EVENTS_TID, EventLog,
                             TRACE_SCHEMA_VERSION, TraceRecorder,
                             format_summary, load_trace, summarize_trace,
                             validate_chrome_trace)
from repro_torch.obs import trace as port_trace
from repro.obs import trace as ref_trace
from repro_torch.service import make_mlp
from test_torch_planner import port_profile, to_port

ROOT = os.path.join(os.path.dirname(__file__), "..")
REF_PROFILE = rc.MachineProfile(host_link_bw=16e9, compute_flops=5e10,
                                mem_bw=1e10)
PROFILE = port_profile(REF_PROFILE)


def _plain(x):
    if hasattr(x, "value"):
        return x.value
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.fixture(scope="module")
def chain_plans():
    """``synthetic_chain`` planned by both packages at 0.6 of its
    unscheduled peak (the same plan: the planners are copies)."""
    jseq = synthetic_chain(n_ops=12, job_id="job0")
    pseq = to_port(jseq)
    budget = int(0.6 * rc.analyze([jseq]).peak_bytes)
    rplan = rc.schedule_single(jseq, profile=REF_PROFILE,
                               budget_bytes=budget).plans["job0"]
    pplan = tc.schedule_single(pseq, profile=PROFILE,
                               budget_bytes=budget).plans["job0"]
    assert _plain(pplan.to_dict()) == _plain(rplan.to_dict())
    assert pplan.events
    return jseq, rplan, pseq, pplan


def _sim(mod, recorder_cls, seq, plan, profile, budget=None,
         recorder=True, mode="sync"):
    hub = mod.TelemetryHub(clock="virtual")
    eng = mod.MemoryEngine(profile, telemetry=hub)
    rec = recorder_cls(clock="virtual", budget_bytes=budget)
    if recorder:
        eng.attach_recorder(rec)
    res = mod.simulate([seq], {seq.job_id: plan}, profile, iterations=1,
                       transfer_mode=mode, engine=eng, telemetry=hub)
    return rec.to_chrome(), res


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_sim_trace_is_the_references(chain_plans, mode):
    """The same plan simulated by both packages renders the same Chrome
    trace: every event, timestamp and counter, and ``otherData`` (which
    names no package)."""
    jseq, rplan, pseq, pplan = chain_plans
    budget = pplan.planned_peak_bytes
    ref, _ = _sim(rc, RefTraceRecorder, jseq, rplan, REF_PROFILE, budget,
                  mode=mode)
    port, _ = _sim(tc, TraceRecorder, pseq, pplan, PROFILE, budget,
                   mode=mode)
    assert port["otherData"] == ref["otherData"] == {
        "clock": "virtual", "schema": TRACE_SCHEMA_VERSION}
    assert json.dumps(port, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)
    assert validate_chrome_trace(port) == []
    assert summarize_trace(port) == ref_trace.summarize_trace(ref)
    assert format_summary(summarize_trace(port)) == \
        ref_trace.format_summary(ref_trace.summarize_trace(ref))
    assert (port_trace.TRACE_SCHEMA_VERSION, DMA_TID, EVENTS_TID) == (
        ref_trace.TRACE_SCHEMA_VERSION, ref_trace.DMA_TID,
        ref_trace.EVENTS_TID)


def test_sim_trace_is_valid_chrome_trace(chain_plans):
    _, _, seq, plan = chain_plans
    trace, _ = _sim(tc, TraceRecorder, seq, plan, PROFILE,
                    budget=plan.planned_peak_bytes)
    assert validate_chrome_trace(trace) == []
    evs = [e for e in trace["traceEvents"] if e.get("ph") != "M"]
    assert any(e["ph"] == "X" and e.get("cat") == "op" for e in evs)
    assert any(e.get("tid") == DMA_TID and e.get("cat") == "transfer"
               for e in evs)
    counters = {e["name"] for e in evs if e["ph"] == "C"}
    assert {"resident:job0", "device_used_bytes",
            "device_budget_bytes"} <= counters
    assert min(e["ts"] for e in evs) == 0.0
    names = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"job:job0", "dma"} <= names


def test_budget_violation_instants(chain_plans):
    _, _, seq, plan = chain_plans
    trace, _ = _sim(tc, TraceRecorder, seq, plan, PROFILE, budget=1)
    assert validate_chrome_trace(trace) == []
    assert summarize_trace(trace)["budget_violations"]
    roomy, _ = _sim(tc, TraceRecorder, seq, plan, PROFILE, budget=1 << 30)
    assert summarize_trace(roomy)["budget_violations"] == []


def test_trace_json_serializable_and_summary(chain_plans, tmp_path):
    _, _, seq, plan = chain_plans
    rec = TraceRecorder(clock="virtual")
    eng = tc.MemoryEngine(PROFILE, telemetry=tc.TelemetryHub("virtual"))
    eng.attach_recorder(rec)
    tc.simulate([seq], {seq.job_id: plan}, PROFILE, iterations=1,
                transfer_mode="sync", engine=eng)
    path = str(tmp_path / "sub" / "t.trace.json")
    dumped = rec.dump(path)
    trace = load_trace(path)
    assert trace == json.loads(json.dumps(dumped))
    assert validate_chrome_trace(trace) == []
    summary = summarize_trace(trace)
    assert summary["jobs"] == ["job0"]
    assert summary["transfer_count"] > 0
    assert 0.0 <= summary["stall_share"]["job0"] <= 1.0
    assert os.listdir(tmp_path / "sub") == ["t.trace.json"]


def test_no_recorder_is_identity(chain_plans):
    _, _, seq, plan = chain_plans
    assert tc.TelemetryHub(clock="virtual")._recorder is None
    assert tc.MemoryEngine(PROFILE).recorder is None
    _, bare = _sim(tc, TraceRecorder, seq, plan, PROFILE, recorder=False)
    _, taped = _sim(tc, TraceRecorder, seq, plan, PROFILE)
    assert bare.peak_bytes == taped.peak_bytes
    assert bare.total_time == taped.total_time


def test_validate_rejects_malformed():
    bad = {"traceEvents": [
        {"ph": "Z", "name": "x", "ts": 0, "pid": 1},
        {"ph": "X", "name": "x", "ts": -1, "pid": 1, "tid": 1, "dur": 1},
        {"ph": "X", "name": "x", "ts": 0, "pid": 1, "tid": 1},
        {"ph": "C", "name": "c", "ts": 0, "pid": 1, "args": {"v": "high"}},
    ]}
    for case in ([], {"traceEvents": "nope"}, {"traceEvents": []}, bad,
                 {"traceEvents": [{"ph": "M", "name": "bogus",
                                   "args": {"name": "x"}}]},
                 {"traceEvents": [{"ph": "i", "name": "x", "ts": 0,
                                   "pid": 1, "s": "q"}]}):
        errs = validate_chrome_trace(case)
        assert errs and errs == ref_trace.validate_chrome_trace(case)
    assert len(validate_chrome_trace(bad)) == 4


def test_event_log_bounded_and_forwarded():
    traces = []
    for log_cls, rec_cls in ((EventLog, TraceRecorder),
                             (RefEventLog, RefTraceRecorder)):
        rec = rec_cls()
        log = log_cls(maxlen=2, clock=lambda: 42.0)
        log.attach_recorder(rec)
        log.info("boot", "starting")
        log.warn("experience", "flush failed", job_id="j", error="IOError()")
        log.error("replan", "replan failed")
        assert len(log) == 2 and log.dropped == 1
        assert [e["name"] for e in rec.extras] == [
            "INFO:boot", "WARN:experience", "ERROR:replan"]
        traces.append(rec.to_chrome())
    assert traces[0] == traces[1]
    assert validate_chrome_trace(traces[0]) == []
    assert any(e.get("tid") == EVENTS_TID for e in traces[0]["traceEvents"]
               if e.get("ph") == "i")


# ------------------------------------------------------- the real executor
@pytest.fixture(scope="module")
def mlp_with_plan():
    step, params, opt, batch = make_mlp((64, 128, 128, 8), 16,
                                        device="cpu")
    seq, gm = tc.capture_train_step(step, params, opt, batch)
    plan = tc.schedule_single(seq, profile=PROFILE).plans[seq.job_id]
    return seq, gm, (params, opt, batch), plan


def _real_trace(mlp_with_plan, budget=None):
    seq, gm, args, plan = mlp_with_plan
    hub = tc.TelemetryHub(clock="real")
    eng = tc.MemoryEngine(PROFILE, telemetry=hub)
    rec = TraceRecorder(clock="real", budget_bytes=budget)
    eng.attach_recorder(rec)
    ex = tc.FxExecutor(gm, seq, plan, engine=eng)
    ex.run(*args)
    ex.close()
    return rec.to_chrome()


def test_sim_and_real_traces_share_schema(mlp_with_plan):
    """A virtual-time and a wall-clock run of the same job and plan give
    the same event names, categories and args schema; only the clock
    differs."""
    seq, _, _, plan = mlp_with_plan
    sim, _ = _sim(tc, TraceRecorder, seq, plan, PROFILE)
    real = _real_trace(mlp_with_plan)
    assert validate_chrome_trace(sim) == []
    assert validate_chrome_trace(real) == []
    assert sim["otherData"]["clock"] == "virtual"
    assert real["otherData"]["clock"] == "real"

    def shape(trace):
        out = {}
        for e in trace["traceEvents"]:
            if e.get("ph") == "M":
                continue
            out.setdefault((e.get("cat"), e["ph"]), set()).add(
                (e["name"], tuple(sorted(e.get("args", {})))))
        return out

    s, r = shape(sim), shape(real)
    assert s.keys() == r.keys()
    assert s[("op", "X")] == r[("op", "X")]
    assert s[("residency", "C")] == r[("residency", "C")]
    assert s[("transfer", "X")] == r[("transfer", "X")]
    # the port's op spans are named by their aten operators
    assert "mm" in {n for n, _ in r[("op", "X")]}


# ------------------------------------------------------------- the tool
def _tool(*args, timeout=300):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "tensile_trace_torch.py"), *args],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=timeout)


def test_trace_tool_records_validates_and_summarizes(tmp_path):
    for flag in ((), ("--real",)):
        out = str(tmp_path / f"t{len(flag)}.json")
        res = _tool("record", "--out", out, "--iterations", "1",
                    "--device", "cpu", *flag)
        assert res.returncode == 0, res.stdout + res.stderr
        clock = "real" if flag else "virtual"
        assert f"({clock} clock, 1 iteration(s))" in res.stdout
        assert load_trace(out)["otherData"]["runtime"] == (
            "executor" if flag else "simulator")
        res = _tool("validate", out)
        assert res.returncode == 0 and "valid" in res.stdout
        res = _tool("summary", out, "--json")
        assert json.loads(res.stdout)["jobs"] == ["trace0"]
    (tmp_path / "bad.json").write_text('{"traceEvents": []}')
    assert _tool("validate", str(tmp_path / "bad.json")).returncode == 1


def test_trace_tool_metrics_smoke_on_the_cpu(tmp_path):
    res = _tool("metrics-smoke", "--root", str(tmp_path / "m"), "--device",
                "cpu", "--out", str(tmp_path / "metrics.prom"))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "metrics smoke OK" in res.stdout
    assert (tmp_path / "metrics.prom").exists()
