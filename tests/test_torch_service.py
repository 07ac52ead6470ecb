"""The port's service plane (``repro_torch.service``: ``JobStore``,
``SchedulerDaemon``, ``ServiceClient``; ``launch/serve.py``;
``tools/tensile_svc_torch.py``) against the JAX package's, on the CPU.

Every case of the reference's ``tests/test_service.py`` runs on both
packages with the reference's ``FakeController`` pattern: the same calls
must give the same admission decisions, store records (``jobs.jsonl``
lines), recover results, queue state and ``status()``.  The daemons stamp
records with the wall clock, so both read one fixed clock here.  Both
stores write one file format, so each package reads the other's.  The real
controller runs the port's daemon end to end on ``device="cpu"``; the
reference's runs beside it, and the two agree on states and on the source
of each prediction (the peaks are each package's own graph's).
"""
import json
import os
import subprocess
import sys
import types

import pytest
import torch

import repro.service as ref_service
import repro.service.daemon as ref_daemon
import repro_torch.service as service
import repro_torch.service.daemon as port_daemon
from repro_torch.obs import parse_metrics_text
from repro_torch.service import (JobSpec, JobState, SchedulerDaemon,
                                 ServiceClient, workloads)

ROOT = os.path.join(os.path.dirname(__file__), "..")
PACKAGES = {"port": (service, port_daemon), "ref": (ref_service, ref_daemon)}
CLOCK = types.SimpleNamespace(time=lambda: 1000.0,
                              sleep=lambda s: None)


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both daemons read one clock, so their records compare whole."""
    for _, mod in PACKAGES.values():
        monkeypatch.setattr(mod, "_time", CLOCK)


# ---------------------------------------------------- the reference's double
class FakeHandle:
    def __init__(self, peak=0):
        self.done = False
        self.error = None
        self.stats = []
        self.peak_bytes = peak


class FakeController:
    """Admission-API double: capture_spec / predict_peak / submit."""

    def __init__(self, peaks):
        self.peaks = dict(peaks)      # job_id -> (predicted, source)
        self.handles = {}

    def capture_spec(self, spec):
        if spec.workload == "unresolvable":
            raise ValueError(f"job {spec.job_id!r}: unknown workload")
        return types.SimpleNamespace(
            seq=types.SimpleNamespace(job_id=spec.job_id))

    def predict_peak(self, seq, budget_hint_bytes=None):
        return self.peaks[seq.job_id]

    def submit(self, spec, captured=None):
        h = FakeHandle()
        self.handles[spec.job_id] = h
        return h


def _daemon(pkg, root, peaks, capacity):
    svc, _ = PACKAGES[pkg]
    return svc.SchedulerDaemon(str(root), controller=FakeController(peaks),
                               capacity_bytes=capacity, poll_interval=0.01)


def _snapshot(d) -> dict:
    """What a daemon decided: every record as its wire line, the queue,
    the recover result and ``status()``."""
    return {"records": {j: r.to_dict() for j, r in d.store.all().items()},
            "waiting": [(q.job_id, q.predicted_peak_bytes)
                        for q in d.queue.waiting],
            "reserved": d.queue.reserved_bytes,
            "recovered": d.recovered, "status": d.status()}


def _both(tmp_path, scenario) -> dict:
    """``scenario(pkg, root)`` on both packages, each in its own root; the
    port's daemon and snapshot, after checking the two snapshots agree."""
    out = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg
        root.mkdir()
        d = scenario(pkg, root)
        out[pkg] = (d, _snapshot(d))
    assert out["port"][1] == out["ref"][1]
    return out["port"][0]


# ------------------------------------------------------------- JobSpec
def test_jobspec_wire_roundtrip():
    for svc, _ in PACKAGES.values():
        spec = svc.JobSpec("j1", workload="mlp",
                           workload_params={"size": "small"}, priority=2.0,
                           iterations=3, budget_hint_bytes=123,
                           offset_frac=0.5, fingerprint="abc")
        wire = spec.to_dict()
        assert wire["schema"] == svc.SPEC_SCHEMA_VERSION
        assert "payload" not in wire
        assert json.loads(json.dumps(wire)) == wire
        assert svc.JobSpec.from_dict(wire) == spec
    assert service.SPEC_SCHEMA_VERSION == ref_service.SPEC_SCHEMA_VERSION


def test_jobspec_is_frozen_and_validates():
    for svc, _ in PACKAGES.values():
        spec = svc.JobSpec("j1", workload="mlp")
        with pytest.raises(Exception):
            spec.job_id = "other"
        for kw in ({"job_id": ""}, {"iterations": 0}, {"priority": 0.0},
                   {"budget_hint_bytes": -1}, {"payload": (1, 2)}):
            args = dict({"job_id": "j"}, **kw)
            with pytest.raises(ValueError):
                svc.JobSpec(**args)


def test_jobspec_payload_never_crosses_the_wire():
    for svc, _ in PACKAGES.values():
        spec = svc.JobSpec("j1", payload=(lambda *a: None, 1, 2, 3))
        wire = spec.to_dict()
        assert "payload" not in wire
        assert svc.JobSpec.from_dict({**wire, "payload": "x"}).payload is None


def test_jobspec_from_dict_tolerance():
    for svc, _ in PACKAGES.values():
        assert svc.JobSpec.from_dict({"job_id": "j", "future": 1}).job_id \
            == "j"
        for bad in ({"job_id": "j", "schema": 99}, {"workload": "mlp"},
                    "not a dict"):
            with pytest.raises(ValueError):
                svc.JobSpec.from_dict(bad)


def test_jobstate_terminal():
    assert [(s.value, s.terminal) for s in JobState] == \
        [(s.value, s.terminal) for s in ref_service.JobState]
    assert JobState.DONE.terminal and JobState.FAILED.terminal \
        and JobState.REJECTED.terminal
    assert not (JobState.QUEUED.terminal or JobState.ADMITTED.terminal
                or JobState.RUNNING.terminal)


# ----------------------------------------------------------- workloads
def test_workload_registry_and_import_path(monkeypatch):
    for svc, _ in PACKAGES.values():
        monkeypatch.setattr(svc.workloads, "_REGISTRY",
                            dict(svc.workloads._REGISTRY))
        svc.register_workload("svc-test", lambda x=1: ("fn", "p", "o", x))
        spec = svc.JobSpec("j", workload="svc-test",
                           workload_params={"x": 7})
        assert svc.resolve_workload(spec) == ("fn", "p", "o", 7)
        with pytest.raises(ValueError):
            svc.register_workload("bad:name", lambda: None)
        for bad in ({"workload": "no-such-workload"},
                    {"workload": "no.such.module:attr"}, {}):
            with pytest.raises(ValueError):
                svc.resolve_workload(svc.JobSpec("j", **bad))
        payload = ("f", "p", "o", "b")
        assert svc.resolve_workload(svc.JobSpec(
            "j", workload="svc-test", payload=payload)) == payload


def test_resolution_takes_the_owners_device(monkeypatch):
    """The port's departure: a caller that owns a device (the controller)
    passes it to a factory that takes one and was given none, so a spec
    that crossed the inbox runs where the daemon runs; params that name a
    device, and factories without one, are left as they are."""
    monkeypatch.setattr(workloads, "_REGISTRY", dict(workloads._REGISTRY))
    seen = []
    workloads.register_workload(
        "dev", lambda device=None: seen.append(device) or (1, 2, 3, 4))
    workloads.register_workload("nodev", lambda x=1: ("no", x, 3, 4))
    cpu = torch.device("cpu")
    workloads.resolve_workload(JobSpec("j", workload="dev"), device=cpu)
    workloads.resolve_workload(JobSpec("j", workload="dev",
                                       workload_params={"device": "meta"}),
                               device=cpu)
    workloads.resolve_workload(JobSpec("j", workload="dev"))
    assert seen == [cpu, "meta", None]
    assert workloads.resolve_workload(JobSpec("j", workload="nodev"),
                                      device=cpu) == ("no", 1, 3, 4)
    _, params, _, _ = workloads.resolve_workload(
        JobSpec("j", workload="mlp", workload_params={"size": "small"}),
        device=cpu)
    assert params[0]["w"].device == cpu


# ------------------------------------------------------ AdmissionQueue
def test_admission_queue_priority_and_backfill():
    for svc, _ in PACKAGES.values():
        q = svc.AdmissionQueue(100)
        q.push("big", 80, priority=1.0)
        assert [j.job_id for j in q.pop_admissible()] == ["big"]
        assert q.reserved_bytes == 80
        q.push("blocked", 50, priority=9.0)
        q.push("small", 15, priority=1.0)
        assert [j.job_id for j in q.pop_admissible()] == ["small"]
        assert [j.job_id for j in q.waiting] == ["blocked"]
        q.release("big")
        assert [j.job_id for j in q.pop_admissible()] == ["blocked"]
        assert q.reserved_bytes == 65
        assert q.max_reserved_bytes <= q.capacity_bytes


def test_admission_queue_rejects_never_admissible_and_duplicates():
    for svc, _ in PACKAGES.values():
        q = svc.AdmissionQueue(100)
        with pytest.raises(ValueError):
            q.push("huge", 101)
        q.push("a", 10)
        with pytest.raises(ValueError):
            q.push("a", 10)
        q.pop_admissible()
        with pytest.raises(ValueError):
            q.push("a", 10)


def test_admission_queue_refine_shrinks_and_clamps():
    for svc, _ in PACKAGES.values():
        q = svc.AdmissionQueue(100)
        q.push("a", 90)
        q.pop_admissible()
        assert q.refine("a", 40) == 40
        assert q.free_bytes == 60
        assert q.refine("a", 500) == 100
        assert q.reserved_bytes == 100
        assert q.refine("ghost", 10) is None
        assert q.release("a") == 100
        assert q.reserved_bytes == 0


# ------------------------------------------------------------ JobStore
def _fill_store(svc, root):
    store = svc.JobStore(str(root))
    rec = svc.JobRecord(spec=svc.JobSpec("j1", workload="mlp", iterations=2),
                        state=svc.JobState.QUEUED, submitted_at=1.0)
    store.put(rec, now=1.0)
    store.transition("j1", svc.JobState.ADMITTED, now=2.0,
                     predicted_peak_bytes=123, predicted_source="cost-model")
    store.transition("j1", svc.JobState.RUNNING, now=3.0)
    store.transition("j1", svc.JobState.DONE, now=4.0,
                     measured_peak_bytes=99)
    return rec


def test_jobstore_roundtrip_and_transitions(tmp_path):
    for pkg, (svc, _) in PACKAGES.items():
        rec = _fill_store(svc, tmp_path / pkg)
        again = svc.JobStore(str(tmp_path / pkg)).get("j1")
        assert again.state is svc.JobState.DONE
        assert (again.admitted_at, again.started_at, again.finished_at) \
            == (2.0, 3.0, 4.0)
        assert again.predicted_peak_bytes == 123
        assert again.measured_peak_bytes == 99
        assert again.spec == rec.spec
    assert service.STORE_SCHEMA_VERSION == ref_service.STORE_SCHEMA_VERSION
    assert (tmp_path / "port" / "jobs.jsonl").read_text() == \
        (tmp_path / "ref" / "jobs.jsonl").read_text()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_store_reads_the_same_in_either_package(tmp_path, writer):
    """``jobs.jsonl`` is one format: what one package's store writes, the
    other's reads into the same records (and a recover of it agrees)."""
    svc, _ = PACKAGES[writer]
    _fill_store(svc, tmp_path)
    store = svc.JobStore(str(tmp_path))
    for jid, state, requeues in [("q", "QUEUED", 0), ("r", "RUNNING", 0),
                                 ("r2", "RUNNING", 1)]:
        store.put(svc.JobRecord(spec=svc.JobSpec(jid, workload="mlp"),
                                state=svc.JobState(state),
                                requeues=requeues), now=5.0)
    wire = {p: {j: r.to_dict() for j, r in s.JobStore(str(tmp_path))
                .all().items()} for p, (s, _) in PACKAGES.items()}
    assert wire["port"] == wire["ref"]
    assert len(wire["port"]) == 4
    reader = "ref" if writer == "port" else "port"
    got = PACKAGES[reader][0].JobStore(str(tmp_path)).recover(now=6.0)
    assert got == (["q"], ["r"], ["r2"])


def test_jobstore_corrupt_lines_skip_not_crash(tmp_path):
    for pkg, (svc, _) in PACKAGES.items():
        root = tmp_path / pkg
        root.mkdir()
        good = svc.JobRecord(spec=svc.JobSpec("ok", workload="mlp")).to_dict()
        lines = [
            json.dumps({"kind": "header", "schema": svc.JobStore.SCHEMA}),
            json.dumps(good),
            "{ not json at all",
            json.dumps({"kind": "job", "spec": {"schema": 99,
                                                "job_id": "bad"},
                        "state": "QUEUED"}),
            json.dumps({"kind": "job", "state": "QUEUED"}),
            json.dumps(["not", "a", "dict"]),
        ]
        (root / "jobs.jsonl").write_text("\n".join(lines) + "\n")
        assert set(svc.JobStore(str(root)).all()) == {"ok"}


def test_jobstore_header_mismatch_degrades_to_empty(tmp_path):
    for svc, _ in PACKAGES.values():
        path = tmp_path / "jobs.jsonl"
        rec = svc.JobRecord(spec=svc.JobSpec("j", workload="mlp")).to_dict()
        path.write_text(json.dumps({"kind": "header", "schema": 999}) + "\n"
                        + json.dumps(rec) + "\n")
        assert len(svc.JobStore(str(tmp_path))) == 0
        path.write_text(json.dumps(rec) + "\n")
        assert len(svc.JobStore(str(tmp_path))) == 0


def test_jobstore_recover_rules(tmp_path):
    results = {}
    for pkg, (svc, _) in PACKAGES.items():
        store = svc.JobStore(str(tmp_path / pkg))
        for jid, state, requeues in [("q", "QUEUED", 0), ("a", "ADMITTED", 0),
                                     ("r", "RUNNING", 0),
                                     ("r2", "RUNNING", 1), ("d", "DONE", 0)]:
            store.put(svc.JobRecord(spec=svc.JobSpec(jid, workload="mlp"),
                                    state=svc.JobState(state),
                                    requeues=requeues), now=1.0)
        results[pkg] = (store.recover(now=2.0), {
            j: r.to_dict() for j, r in
            svc.JobStore(str(tmp_path / pkg)).all().items()})
    assert results["port"] == results["ref"]
    (replayed, requeued, failed), recs = results["port"]
    assert set(replayed) == {"q", "a"}
    assert requeued == ["r"] and recs["r"]["requeues"] == 1
    assert recs["r"]["state"] == "QUEUED"
    assert failed == ["r2"] and recs["r2"]["state"] == "FAILED"
    assert "orphaned" in recs["r2"]["error"]
    assert recs["d"]["state"] == "DONE"


# ---------------------------------------------------- daemon (faked)
def test_daemon_holds_then_admits_when_capacity_frees(tmp_path, fixed_clock):
    def scenario(pkg, root):
        svc, _ = PACKAGES[pkg]
        d = _daemon(pkg, root, {"a": (800, "experience"),
                                "b": (300, "experience")}, capacity=1000)
        d.submit(svc.JobSpec("a", workload="w"))
        d.submit(svc.JobSpec("b", workload="w"))
        d.step(now=1.0)
        assert d.store.get("a").state.value == "RUNNING"
        assert d.store.get("b").state.value == "QUEUED"
        d.controller.handles["a"].done = True
        d.controller.handles["a"].peak_bytes = 750
        d.step(now=2.0)
        return d

    d = _both(tmp_path, scenario)
    assert d.store.get("a").state is JobState.DONE
    assert d.store.get("a").measured_peak_bytes == 750
    assert d.store.get("b").state is JobState.RUNNING
    assert d.store.get("b").started_at == 2.0


def test_daemon_refines_conservative_bound_after_profiled_iteration(
        tmp_path, fixed_clock):
    def scenario(pkg, root):
        svc, _ = PACKAGES[pkg]
        d = _daemon(pkg, root, {"a": (900, "cost-model"),
                                "b": (300, "experience")}, capacity=1000)
        d.submit(svc.JobSpec("a", workload="w"))
        d.submit(svc.JobSpec("b", workload="w"))
        d.step(now=1.0)
        assert d.store.get("b").state.value == "QUEUED"
        h = d.controller.handles["a"]
        h.stats.append(object())
        h.peak_bytes = 400
        d.step(now=2.0)
        return d

    d = _both(tmp_path, scenario)
    assert d.store.get("a").measured_peak_bytes == 400
    assert d.store.get("b").state is JobState.RUNNING
    assert d.queue.reserved_bytes == 700


def test_daemon_rejects_never_fitting_and_unresolvable(tmp_path,
                                                      fixed_clock):
    def scenario(pkg, root):
        svc, _ = PACKAGES[pkg]
        d = _daemon(pkg, root, {"huge": (2000, "cost-model")},
                    capacity=1000)
        d.submit(svc.JobSpec("huge", workload="w"))
        d.submit(svc.JobSpec("nope", workload="unresolvable"))
        return d

    d = _both(tmp_path, scenario)
    assert d.store.get("huge").state is JobState.REJECTED
    assert "never admissible" in d.store.get("huge").error
    assert d.store.get("nope").state is JobState.REJECTED


def test_daemon_submit_is_idempotent(tmp_path, fixed_clock):
    def scenario(pkg, root):
        svc, _ = PACKAGES[pkg]
        d = _daemon(pkg, root, {"a": (10, "experience")}, capacity=1000)
        r1 = d.submit(svc.JobSpec("a", workload="w"))
        r2 = d.submit(svc.JobSpec("a", workload="w", iterations=5))
        assert r2 is r1
        d.step(now=1.0)
        return d

    d = _both(tmp_path, scenario)
    assert d.store.get("a").state is JobState.RUNNING
    assert d.store.get("a").spec.iterations == 1


def test_daemon_crash_recovery_requeues_orphan_exactly_once(tmp_path,
                                                           fixed_clock):
    peaks = {j: (10, "experience") for j in ("q", "a", "r")}
    seconds = {}

    def scenario(pkg, root):
        svc, _ = PACKAGES[pkg]
        store = svc.JobStore(str(root))
        for jid, state in [("q", "QUEUED"), ("a", "ADMITTED"),
                           ("r", "RUNNING")]:
            store.put(svc.JobRecord(spec=svc.JobSpec(jid, workload="w"),
                                    state=svc.JobState(state),
                                    submitted_at=1.0), now=1.0)
        d = _daemon(pkg, root, peaks, capacity=1000)
        assert set(d.recovered["replayed"]) == {"q", "a"}
        assert d.recovered["requeued_orphans"] == ["r"]
        d.step(now=2.0)
        assert all(d.store.get(j).state.value == "RUNNING"
                   for j in ("q", "a", "r"))
        seconds[pkg] = _snapshot(d)
        # crash again mid-run: q and a spend their one re-queue, r is
        # failed for good
        return _daemon(pkg, root, peaks, capacity=1000)

    d2 = _both(tmp_path, scenario)
    assert seconds["port"] == seconds["ref"]
    assert d2.recovered["failed_orphans"] == ["r"]
    assert d2.store.get("r").state is JobState.FAILED
    assert "orphaned" in d2.store.get("r").error
    assert set(d2.recovered["requeued_orphans"]) == {"q", "a"}


def test_daemon_hands_the_capture_to_the_controller(tmp_path):
    """The port's departure: once the controller has a job, the daemon
    holds no reference to its capture (the controller donates the state
    to its executors); the reference's keeps it until the job is done.
    A job still waiting keeps its capture, so admission never captures
    twice."""
    captures = {}
    for pkg, (svc, _) in PACKAGES.items():
        d = _daemon(pkg, tmp_path / pkg, {"a": (800, "experience"),
                                          "b": (300, "experience")},
                    capacity=1000)
        d.submit(svc.JobSpec("a", workload="w"))
        d.submit(svc.JobSpec("b", workload="w"))
        d.step(now=1.0)
        captures[pkg] = sorted(d._captured)
    assert captures == {"port": ["b"], "ref": ["a", "b"]}


def test_daemon_drain_inbox_skips_corrupt_submissions(tmp_path, fixed_clock):
    def scenario(pkg, root):
        svc, _ = PACKAGES[pkg]
        d = _daemon(pkg, root, {"ok": (10, "experience")}, capacity=1000)
        ok = svc.JobSpec("ok", workload="w").to_dict()
        (root / "inbox" / "ok.json").write_text(json.dumps(ok))
        (root / "inbox" / "garbage.json").write_text("{ nope")
        (root / "inbox" / "badspec.json").write_text(
            json.dumps({"schema": 99, "job_id": "x"}))
        d.step(now=1.0)
        assert os.listdir(root / "inbox") == []
        return d

    d = _both(tmp_path, scenario)
    assert d.store.get("ok").state is JobState.RUNNING
    assert d.store.get("x") is None


def test_daemon_heartbeat_and_metrics_match_the_reference(tmp_path,
                                                         fixed_clock):
    """The heartbeat's fields (less the pid) and the Prometheus text are
    the reference's for the same decisions."""
    def scenario(pkg, root):
        svc, _ = PACKAGES[pkg]
        d = _daemon(pkg, root, {"a": (800, "experience"),
                                "huge": (5000, "cost-model")}, capacity=1000)
        d.submit(svc.JobSpec("a", workload="w"))
        d.submit(svc.JobSpec("huge", workload="w"))
        d.step(now=1.0)
        d.drain(timeout=0.0)
        return d

    _both(tmp_path, scenario)
    hb = {p: json.loads((tmp_path / p / "daemon.json").read_text())
          for p in PACKAGES}
    for h in hb.values():
        h.pop("pid")
    assert hb["port"] == hb["ref"]
    text = {p: (tmp_path / p / "metrics.prom").read_text() for p in PACKAGES}
    assert text["port"] == text["ref"]
    parsed = parse_metrics_text(text["port"])
    assert parsed[("tensile_jobs", (("state", "REJECTED"),))] == 1
    assert parsed[("tensile_reserved_bytes", ())] == 800


# ------------------------------------------------------------- client
def test_client_wire_submission_and_drain(tmp_path, fixed_clock):
    def scenario(pkg, root):
        svc, _ = PACKAGES[pkg]
        d = _daemon(pkg, root, {"w1": (10, "experience")}, capacity=1000)
        client = svc.ServiceClient(str(root))
        client.submit(svc.JobSpec("w1", workload="w", iterations=2))
        client.drain()
        d.step(now=1.0)
        assert d._draining
        assert client.states()["w1"] == "RUNNING"
        d.controller.handles["w1"].done = True
        d.step(now=2.0)
        return d

    d = _both(tmp_path, scenario)
    recs = ServiceClient(str(d.root)).wait(["w1"], timeout=5.0)
    assert recs["w1"].state is JobState.DONE


@pytest.mark.parametrize("client_pkg", ["port", "ref"])
def test_a_client_of_one_package_drives_the_others_daemon(tmp_path,
                                                         client_pkg):
    """The inbox and the store are one wire format: a client of either
    package submits to, drains and reads a daemon of the other."""
    daemon_pkg = "ref" if client_pkg == "port" else "port"
    d = _daemon(daemon_pkg, tmp_path, {"x": (10, "experience")},
                capacity=1000)
    svc, _ = PACKAGES[client_pkg]
    client = svc.ServiceClient(str(tmp_path))
    client.submit(svc.JobSpec("x", workload="w"))
    client.drain()
    d.step(now=1.0)
    d.controller.handles["x"].done = True
    d.step(now=2.0)
    assert client.states() == {"x": "DONE"}
    assert client.daemon_alive(stale_after=1e12)
    assert client.wait(["x"], timeout=5.0)["x"].state.value == "DONE"


def test_client_refuses_payload_specs(tmp_path):
    for svc, _ in PACKAGES.values():
        client = svc.ServiceClient(str(tmp_path))
        with pytest.raises(ValueError):
            client.submit(svc.JobSpec("p", payload=("f", 1, 2, 3)))
        with pytest.raises(ValueError):
            client.submit(svc.JobSpec("p"))


# ------------------------------------------- deprecated launch() shim
def test_launch_shim_warns_and_still_runs():
    import repro_torch.core as tc
    from repro_torch.service import make_mlp

    gc = tc.GlobalController(device="cpu")
    with pytest.warns(DeprecationWarning, match="submit"):
        h = gc.launch(*make_mlp((32, 64, 64, 4), 8, device="cpu"),
                      job_id="shim-job", iterations=1)
    gc.wait(timeout=300)
    assert h.done and h.error is None
    assert h.spec is not None and h.spec.job_id == "shim-job"


def test_serve_shim_warns_and_still_runs(capsys):
    from repro_torch.launch import serve
    with pytest.warns(DeprecationWarning, match="serving.cli"):
        rc = serve.main(["--batch", "2", "--requests", "3", "--gen", "4",
                         "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "served=3" in out and "device=cpu" in out


# ------------------------------------------------- real controller e2e
def test_daemon_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SchedulerDaemon(str(tmp_path))


def test_daemon_real_controller_end_to_end(tmp_path):
    """The reference's end-to-end case on both packages' real controllers:
    the same states and prediction sources, the port's on the CPU."""
    recs = {}
    for pkg, (svc, _) in PACKAGES.items():
        kw = {"controller_kwargs": {"device": "cpu"}} if pkg == "port" \
            else {}
        d = svc.SchedulerDaemon(str(tmp_path / pkg), poll_interval=0.01,
                                **kw)
        d.submit(svc.JobSpec("e2e", workload="mlp",
                             workload_params={"size": "small"},
                             iterations=2))
        assert d.drain(timeout=300)
        rec = d.store.get("e2e")
        assert rec.predicted_peak_bytes > 0 and rec.measured_peak_bytes > 0
        again = svc.JobStore(str(tmp_path / pkg)).get("e2e")
        recs[pkg] = (rec.state.value, rec.predicted_source,
                     again.state.value, d.status()["jobs"])
        if pkg == "port":
            assert d.controller.device == torch.device("cpu")
    assert recs["port"] == recs["ref"] == (
        "DONE", "cost-model", "DONE", {"DONE": 1})


def test_daemon_writes_parseable_metrics_file(tmp_path):
    d = SchedulerDaemon(str(tmp_path), controller_kwargs={"device": "cpu"})
    d.step()
    parsed = parse_metrics_text((tmp_path / "metrics.prom").read_text())
    for name in ("tensile_queue_depth", "tensile_capacity_bytes",
                 "tensile_reserved_bytes"):
        assert (name, ()) in parsed
    assert parsed[("tensile_queue_depth", ())] == 0


def test_daemon_runs_a_serve_job_and_exposes_its_rate(tmp_path, monkeypatch):
    """A reduced TinyLlama serve job through the inbox on the CPU: DONE,
    its tokens/s in ``metrics.prom``, and the recorder's ``job:<state>``
    instants on the controller hub's clock (one trace for both)."""
    from repro_torch.obs import TraceRecorder, validate_chrome_trace
    from repro_torch.service import ServeParams

    monkeypatch.setattr(workloads, "_SERVE_REGISTRY",
                        dict(workloads._SERVE_REGISTRY))
    d = SchedulerDaemon(str(tmp_path), poll_interval=0.01,
                        controller_kwargs={"device": "cpu"})
    rec = TraceRecorder(clock="real")
    d.attach_recorder(rec)
    d.controller.engine.attach_recorder(rec)
    client = ServiceClient(str(tmp_path))
    client.submit(JobSpec("s", kind="serve", serve=ServeParams(
        max_sequences=2, n_requests=3, prompt_len=4, gen_len=4)))
    client.submit(JobSpec("m", workload="mlp",
                          workload_params={"size": "small"}))
    client.drain()
    d.start()
    d._thread.join(120)
    assert client.states() == {"s": "DONE", "m": "DONE"}
    parsed = parse_metrics_text((tmp_path / "metrics.prom").read_text())
    assert parsed[("tensile_serve_tokens_per_sec", (("job", "s"),))] > 0
    trace = rec.to_chrome()
    assert validate_chrome_trace(trace) == []
    states = [e for e in trace["traceEvents"]
              if e.get("name", "").startswith("job:")]
    assert sorted(e["name"] for e in states) == sorted(
        ["job:ADMITTED", "job:RUNNING", "job:DONE"] * 2)
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "op"]
    assert ops
    # both clocks are the hub's: the run spans seconds, not decades
    span_us = max(e["ts"] for e in trace["traceEvents"] if "ts" in e)
    assert span_us < 600e6


def test_recorder_gets_admission_spans(tmp_path):
    """The port's departure: with a recorder attached, each admission
    step is a span on the job's track, the capture's with the cost
    model's iteration time, the prediction's with the peak and source the
    store records; a job whose capture the daemon already holds gets no
    capture span.  Both jobs here can never fit, so both are REJECTED."""
    from repro_torch.obs import TraceRecorder, validate_chrome_trace

    d = SchedulerDaemon(str(tmp_path), capacity_bytes=1,
                        controller_kwargs={"device": "cpu"})
    rec = TraceRecorder(clock="real")
    d.attach_recorder(rec)
    held = JobSpec("held", workload="mlp", workload_params={"size": "small"})
    d._captured["held"] = d.controller.capture_spec(held)
    d.submit(JobSpec("new", workload="mlp",
                     workload_params={"size": "small"}))
    d.submit(held)
    trace = rec.to_chrome()
    assert validate_chrome_trace(trace) == []
    tracks = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    spans = {(tracks[e["tid"]], e["name"]): e for e in trace["traceEvents"]
             if e.get("cat") == "admission"}
    assert sorted(spans) == [("job:held", "predict"), ("job:new", "capture"),
                             ("job:new", "predict")]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in spans.values())
    assert spans[("job:new", "capture")]["args"]["iteration_s"] > 0
    for j in ("new", "held"):
        r = d.store.get(j)
        assert r.state is JobState.REJECTED
        assert spans[(f"job:{j}", "predict")]["args"] == {
            "peak_bytes": r.predicted_peak_bytes,
            "source": r.predicted_source}


# ------------------------------------------------------------ the tool
def test_svc_tool_smoke_on_the_cpu(tmp_path):
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "tensile_svc_torch.py"),
         "smoke", "--root", str(tmp_path / "svc"), "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "service smoke OK" in res.stdout


def test_svc_tool_start_refuses_without_a_card(tmp_path):
    code = ("import sys, runpy, torch; torch.cuda.is_available = "
            "lambda: False; sys.argv = ['t', 'start', '--root', "
            f"{str(tmp_path)!r}]; runpy.run_path("
            f"{os.path.join(ROOT, 'tools', 'tensile_svc_torch.py')!r}, "
            "run_name='__main__')")
    res = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(ROOT, "src")),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
