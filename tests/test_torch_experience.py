"""The port's experience plane (``repro_torch.core.experience``), its
cold-start predictor (``cost_model.LatencyMLP``) and the controller's
store hooks, against the JAX package's on the CPU.

Each test of ``tests/test_experience.py`` has a counterpart here on the
port's own captures (``make_mlp`` + ``capture_train_step``, where the
reference captures its jaxpr MLP).  The cross-package tests hand both
packages the same sequences (the reference's, converted field by field by
``test_torch_planner.to_port``) and the same machine profile, and compare
exactly: fingerprints, the records a store holds, ``predicted_peak`` and the
events of a plan ``lookup_plan`` returns are the same Python arithmetic on
the same inputs, and a store either package writes reads in the other.

``LatencyMLP``: ``featurize`` is the same numpy.  With the reference's
initial weights converted (``convert.latency_mlp_from_jax``) a prediction
agrees within rtol 1e-5 (fp32 products in two libraries), and 200 training
steps from that initialisation end within 1e-6 of the reference's R² and
rtol 1e-5 of its predictions (measured: R² equal to the printed digits,
predictions 5e-7 apart relatively).  The port cannot draw JAX's initial
values; its own seed-0 draw at hidden 16 sits on the same flat start
(R² about 0 after 800 steps) that the reference's seed 6 does, so the
reference's monotonicity test runs from the reference's seed-0 weights.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import experience as rexp
from helpers import capture_mlp, synthetic_chain
from test_experience import PROFILE as REF_PROFILE
from test_experience import _populate as ref_populate
import repro_torch.core as tc
from repro_torch.convert import latency_mlp_from_jax
from repro_torch.core import experience as texp
from repro_torch.service import JobSpec, make_mlp
from test_torch_planner import port_profile, to_port

PROFILE = port_profile(REF_PROFILE)
# the reference's capture-time cost model (its CPU-container defaults)
CALIB = tc.DeviceCalibration(flops=5e10, mem_bw=1e10)
ROOT = os.path.join(os.path.dirname(__file__), "..")


def port_mlp(sizes=(16, 32, 8), batch=4, seed=0, params=None,
             job_id="job0"):
    """The port's MLP train step captured on the CPU."""
    step, p, o, b = make_mlp(sizes, batch, seed=seed, params=params,
                             device="cpu")
    seq, gm = tc.capture_train_step(step, p, o, b, job_id=job_id,
                                    cost_model=tc.CostModel(CALIB))
    return seq, gm, (p, o, b)


@pytest.fixture(scope="module")
def mlp_seq():
    return port_mlp()[0]


@pytest.fixture()
def store(tmp_path):
    return tc.ExperienceStore(str(tmp_path / "exp"), device_id="test-device")


def _populate(store, seq, budget=None, iterations=2):
    """The reference test's ``_populate`` through the port: cold-plan the
    sequence, simulate it, and flush the distilled experience; returns
    (budget, plan)."""
    if budget is None:
        budget = tc.build_pipeline("tensile", profile=PROFILE).plan(
            [seq]).final_report.peak_bytes
    res = tc.build_pipeline(
        "tensile", profile=PROFILE,
        config=tc.SchedulerConfig(memory_budget_bytes=budget)).plan([seq])
    hub = tc.TelemetryHub(clock="virtual")
    tc.simulate([seq], {k: p.copy() for k, p in res.plans.items()}, PROFILE,
                iterations=iterations, telemetry=hub)
    cm = tc.CostModel(tc.DeviceCalibration(flops=5e10 / 4, mem_bw=1e10 / 4))
    cm.recalibrate(hub, report=False)
    store.record_job(store.fingerprint(seq), seq=seq, hub=hub,
                     job_id=seq.job_id, plan=res.plans[seq.job_id],
                     pipeline="tensile", calib=cm.calib, calib_samples=17)
    store.flush()
    return budget, res.plans[seq.job_id]


# ---------------------------------------------------------------- fingerprints
def test_fingerprint_stable_across_processes(mlp_seq):
    """The same capture in a fresh interpreter gives the same fingerprint:
    make_fx's positional tensor names do not depend on the process."""
    fp_here = tc.fingerprint(mlp_seq, device_id="x")
    code = (
        "import sys; sys.path.insert(0, 'src')\n"
        "from repro_torch.core import capture_train_step, fingerprint\n"
        "from repro_torch.service import make_mlp\n"
        "step, p, o, b = make_mlp((16, 32, 8), 4, device='cpu')\n"
        "seq, _ = capture_train_step(step, p, o, b, job_id='job0')\n"
        "print(fingerprint(seq, device_id='x'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == fp_here


def test_fingerprint_invariant_to_parameter_values():
    """Different weights and inputs, same structure: same fingerprint."""
    def cap(seed, scale):
        rng = np.random.default_rng(seed)
        sizes = (16, 32, 8)
        params = [{"b": np.zeros(sizes[i + 1], np.float32),
                   "w": (rng.standard_normal((sizes[i], sizes[i + 1]))
                         * scale).astype(np.float32)}
                  for i in range(len(sizes) - 1)]
        return port_mlp(sizes, 4, seed=seed, params=params,
                        job_id="j")[0]

    assert tc.fingerprint(cap(0, 0.02)) == tc.fingerprint(cap(9, 1.7))


def test_fingerprint_differs_across_shape_and_topology(mlp_seq):
    wider = port_mlp(sizes=(16, 64, 8))[0]                # shape
    deeper = port_mlp(sizes=(16, 32, 32, 8))[0]           # topology
    fps = {tc.fingerprint(s) for s in (mlp_seq, wider, deeper)}
    assert len(fps) == 3


def test_fingerprint_salted_by_device_identity(mlp_seq):
    assert tc.fingerprint(mlp_seq, device_id="h100") \
        != tc.fingerprint(mlp_seq, device_id="cpu-container")


def test_fingerprint_ignores_latencies(mlp_seq):
    clone = mlp_seq.clone(mlp_seq.job_id)
    clone.set_latencies([op.latency * 7.5 + 1e-6
                         for op in clone.operators])
    assert tc.fingerprint(clone) == tc.fingerprint(mlp_seq)


# ---------------------------------------------------------------- tolerance
def test_corrupt_store_degrades_to_cold(store, mlp_seq):
    budget, _plan = _populate(store, mlp_seq)
    fp = store.fingerprint(mlp_seq)
    assert store.get(fp) is not None
    # trash the entry file and the device record
    for name in os.listdir(store.dir):
        with open(os.path.join(store.dir, name), "w") as f:
            f.write("{not json\x00garbage\n\xff")
    assert store.get(fp) is None
    assert store.device_calibration() is None
    assert store.lookup_plan(mlp_seq, "tensile", budget,
                             profile=PROFILE) is None
    # a pipeline over the corrupt store plans cold without crashing, and
    # plans what a store-less pipeline plans
    pipe = tc.build_pipeline("tensile", profile=PROFILE,
                             config=tc.SchedulerConfig(
                                 memory_budget_bytes=budget))
    pipe.experience = store
    warm = pipe.plan([mlp_seq])
    cold = tc.build_pipeline("tensile", profile=PROFILE,
                             config=tc.SchedulerConfig(
                                 memory_budget_bytes=budget)).plan([mlp_seq])
    assert warm.plans[mlp_seq.job_id].to_dict() \
        == cold.plans[mlp_seq.job_id].to_dict()


def test_version_mismatch_reads_as_absent(store, mlp_seq):
    _populate(store, mlp_seq)
    fp = store.fingerprint(mlp_seq)
    path = store._path(fp)
    with open(path) as f:
        lines = f.read().splitlines()
    header = json.loads(lines[0])
    header["schema"] = 999
    with open(path, "w") as f:
        f.write("\n".join([json.dumps(header)] + lines[1:]) + "\n")
    assert store.get(fp) is None


def test_corrupt_lines_are_skipped_not_fatal(store, mlp_seq):
    _populate(store, mlp_seq)
    fp = store.fingerprint(mlp_seq)
    path = store._path(fp)
    with open(path) as f:
        lines = f.read().splitlines()
    lines.insert(1, "}}}garbage{{{")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    entry = store.get(fp)
    assert entry is not None
    assert entry.telemetry is not None and entry.telemetry.samples > 0


# ---------------------------------------------------------------- concurrency
def test_atomic_concurrent_writers(tmp_path, mlp_seq):
    """Two writers (separate store handles over one root, as two
    controller processes) flushing the same fingerprint interleaved, with
    a short switch interval: the file parses, the surviving telemetry
    carries the monotone-max sample count, no temporary file survives."""
    root = str(tmp_path / "shared")
    fp = tc.ExperienceStore(root, device_id="d").fingerprint(mlp_seq)
    hub = tc.TelemetryHub(clock="virtual")
    tc.simulate([mlp_seq], None, PROFILE, iterations=1, telemetry=hub)
    errors = []

    def writer(n_flushes):
        try:
            st = tc.ExperienceStore(root, device_id="d")
            for _ in range(n_flushes):
                st.record_job(fp, seq=mlp_seq, hub=hub,
                              job_id=mlp_seq.job_id,
                              calib=tc.DeviceCalibration(), calib_samples=5)
                st.flush()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(12,))
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    reader = tc.ExperienceStore(root, device_id="d")
    entry = reader.get(fp)
    assert entry is not None
    assert entry.telemetry.samples == sum(len(v) for v in hub.ops.values())
    assert not [n for n in os.listdir(reader.dir) if ".tmp." in n]


# ---------------------------------------------------------------- plan cache
def test_plan_cache_rejects_shrunken_budget(store, mlp_seq):
    budget, _plan = _populate(store, mlp_seq)
    hit = store.lookup_plan(mlp_seq, "tensile", budget, profile=PROFILE)
    assert hit is not None
    assert hit.provenance[-1]["action"] == "warm-boot"
    assert store.lookup_plan(mlp_seq, "tensile", budget // 4,
                             profile=PROFILE) is None
    assert store.lookup_plan(mlp_seq, "vdnn", budget,
                             profile=PROFILE) is None


def test_warm_boot_skips_convergence_and_matches_cold_plan(store, mlp_seq):
    budget, cold_plan = _populate(store, mlp_seq)
    pipe = tc.build_pipeline("tensile", profile=PROFILE,
                             config=tc.SchedulerConfig(
                                 memory_budget_bytes=budget))
    pipe.experience = store
    res = pipe.plan([mlp_seq])
    plan = res.plans[mlp_seq.job_id]
    assert res.iterations == 0                      # adopted, not re-run
    assert plan.provenance[-1]["action"] == "warm-boot"
    # the adopted plan is the stored plan, rebased onto the same timeline:
    # the same events, each at its trigger op's end plus its delta.  The
    # planner starts a swap there; it starts a recompute before the op it
    # feeds, which `_rebase_plan` (the reference's) re-anchors at its
    # trigger's end, so this capture's one recompute moves by the span
    # between the two (the reference's jaxpr MLP plans none)
    a = [e.to_dict() for e in cold_plan.events]
    b = [e.to_dict() for e in plan.events]
    assert a and len(a) == len(b)
    moved = 0
    for ea, eb, ev in zip(a, b, plan.events):
        anchor = (mlp_seq.op_end[ev.trigger_op] if ev.trigger_op >= 0
                  else 0.0) + ev.delta
        recompute = ev.event_type is tc.EventType.RECOMPUTE
        if recompute:
            assert abs(eb["start"] - anchor) < 1e-9
            assert abs((eb["end"] - eb["start"])
                       - (ea["end"] - ea["start"])) < 1e-9
            moved += eb["start"] != ea["start"]
        for k, v in ea.items():
            if recompute and k in ("start", "end"):
                continue
            if isinstance(v, float):
                assert abs(v - eb[k]) < 1e-9, (k, v, eb[k])
            else:
                assert v == eb[k], (k, v, eb[k])
    assert moved == sum(e.event_type is tc.EventType.RECOMPUTE
                        for e in plan.events) == 1


def test_rebase_keeps_the_transfer_durations_the_plan_was_certified_with(
        store, mlp_seq):
    """A plan whose planner sized its swaps from a rate below the
    profile's link rate (here a quarter of it; on a card, the rate the
    telemetry or the store measured) keeps every swap where it was when
    rebased onto its own timeline, and verifies at its certified peak:
    the port's rebase keeps the stored transfer durations, where the
    reference's re-derives them from the profile (and on the card's
    full-width step verified a gigabyte above the certified peak)."""
    slow = dataclasses.replace(PROFILE, host_link_bw=PROFILE.host_link_bw / 4)
    budget = tc.build_pipeline("tensile", profile=slow).plan(
        [mlp_seq]).final_report.peak_bytes
    cold = tc.build_pipeline(
        "tensile", profile=slow,
        config=tc.SchedulerConfig(memory_budget_bytes=budget)).plan(
            [mlp_seq]).plans[mlp_seq.job_id]
    store.record_job(store.fingerprint(mlp_seq), seq=mlp_seq,
                     hub=tc.TelemetryHub(clock="virtual"),
                     job_id=mlp_seq.job_id, plan=cold, pipeline="tensile")
    store.flush()
    hit = store.lookup_plan(mlp_seq, "tensile", budget, profile=PROFILE)
    assert hit is not None
    assert hit.planned_peak_bytes == cold.planned_peak_bytes <= budget
    swaps = (tc.EventType.SWAP_OUT, tc.EventType.SWAP_IN)
    a = [e for e in cold.events if e.event_type in swaps]
    b = [e for e in hit.events if e.event_type in swaps]
    assert a and len(a) == len(b)
    for ea, eb in zip(a, b):
        assert abs(ea.start - eb.start) < 1e-12
        assert abs(ea.end - eb.end) < 1e-12
        assert eb.end - eb.start > slow.transfer_time(eb.size_bytes) / 2


def test_no_store_and_empty_store_plans_byte_identical(store, mlp_seq):
    budget = tc.build_pipeline("tensile", profile=PROFILE).plan(
        [mlp_seq]).final_report.peak_bytes
    cfg = tc.SchedulerConfig(memory_budget_bytes=budget)
    cold = tc.build_pipeline("tensile", profile=PROFILE,
                             config=cfg).plan([mlp_seq])
    pipe = tc.build_pipeline("tensile", profile=PROFILE,
                             config=tc.SchedulerConfig(
                                 memory_budget_bytes=budget))
    pipe.experience = store                          # exists but empty
    warm = pipe.plan([mlp_seq])
    assert json.dumps(cold.plans[mlp_seq.job_id].to_dict(), sort_keys=True) \
        == json.dumps(warm.plans[mlp_seq.job_id].to_dict(), sort_keys=True)


def test_rebase_rejects_structurally_stale_plans(store, mlp_seq):
    budget, _plan = _populate(store, mlp_seq)
    other = to_port(synthetic_chain(n_ops=6, job_id=mlp_seq.job_id))
    assert store.lookup_plan(other, "tensile", budget,
                             profile=PROFILE) is None


# ---------------------------------------------------------------- warm boots
def test_cost_model_warm_boots_from_store(store, mlp_seq):
    _populate(store, mlp_seq)
    stored = store.device_calibration()
    assert stored is not None
    cm = tc.CostModel(experience=store)
    assert cm.calib == stored
    explicit = tc.DeviceCalibration(flops=1.0, mem_bw=1.0)
    assert tc.CostModel(explicit, experience=store).calib is explicit
    # an empty store: the H100 data-sheet defaults, never the reference's
    empty = tc.ExperienceStore(str(store.root) + "-empty")
    calib = tc.CostModel(experience=empty).calib
    assert calib == tc.DeviceCalibration() and calib.flops == 989e12
    # capture through the store: latencies from the stored calibration
    step, p, o, b = make_mlp((16, 32, 8), 4, device="cpu")
    seq, _ = tc.capture_train_step(step, p, o, b, experience=store)
    cold, _ = tc.capture_train_step(step, p, o, b,
                                    cost_model=tc.CostModel(stored))
    assert [op.latency for op in seq.operators] \
        == [op.latency for op in cold.operators]


def test_swap_planner_seeds_bandwidth_from_store(store, mlp_seq):
    _populate(store, mlp_seq)
    assert store.bandwidth() is not None
    pl = tc.SwapPlanner(mlp_seq, tc.SchedulingPlan(job_id=mlp_seq.job_id),
                        PROFILE, experience=store)
    seeded = pl._swap_time(1 << 20)
    assert seeded != PROFILE.transfer_time(1 << 20)
    assert seeded == PROFILE.host_link_latency + (1 << 20) / store.bandwidth()


# ---------------------------------------------------------------- controller
def _controller_cycle(root, **kw):
    """Run 1 (fresh store) flushes on job exit; run 2 (a new controller over
    the same directory) warm-boots.  Returns both controllers, run 2's
    handle and the first entry."""
    ctl1 = tc.GlobalController(profile=PROFILE, experience_dir=root,
                               async_swap=False, device="cpu", **kw)
    ctl1.submit(JobSpec("run1", iterations=2,
                        payload=make_mlp((12, 24, 6), 4, device="cpu")))
    ctl1.wait(timeout=120)
    ctl2 = tc.GlobalController(profile=PROFILE, experience_dir=root,
                               arbiter_policy="eor-learned",
                               async_swap=False, device="cpu", **kw)
    return ctl1, ctl2


def test_controller_flushes_and_warm_boots(tmp_path):
    """The reference's cross-run cycle through the port's controller on
    the CPU: run 1 flushes distilled experience on job exit; run 2
    warm-boots its cost model from the persisted calibration, finds the
    fingerprint's entry and attaches an arbiter prior."""
    root = str(tmp_path / "ctl-exp")
    ctl1, ctl2 = _controller_cycle(root)
    assert not ctl1.experience_failures
    fps = ctl1.experience.fingerprints()
    assert len(fps) == 1
    entry = ctl1.experience.get(fps[0])
    assert entry is not None and entry.telemetry.samples > 0
    assert ctl1.experience.device_calibration() is not None

    stored = ctl2.experience.device_calibration()
    assert ctl2.cost_model.calib == stored
    spec = JobSpec("run2", iterations=1,
                   payload=make_mlp((12, 24, 6), 4, device="cpu"))
    cap = ctl2.capture_spec(spec)
    assert ctl2.predict_peak(cap.seq) == (entry.telemetry.peak_bytes,
                                          "experience")
    h = ctl2.submit(spec, cap)
    assert h.fingerprint == fps[0]
    assert "run2" in ctl2.arbiter.priors
    ctl2.wait(timeout=120)
    assert not ctl2.experience_failures
    merged = ctl2.experience.get(fps[0])
    assert merged.telemetry.samples >= entry.telemetry.samples


# ---------------------------------------------------------------- maintenance
def test_prune_export_import_roundtrip(store, tmp_path, mlp_seq):
    _populate(store, mlp_seq)
    fp = store.fingerprint(mlp_seq)
    bundle = store.export_bundle()
    assert fp in bundle["entries"]
    dest = tc.ExperienceStore(str(tmp_path / "dest"),
                              device_id="test-device")
    assert dest.import_bundle(bundle) == 1
    entry = dest.get(fp)
    assert entry is not None
    assert entry.telemetry.samples == store.get(fp).telemetry.samples
    assert dest.device_calibration() is not None
    assert dest.import_bundle(dict(bundle, schema=999)) == 0
    assert dest.prune(min_samples=10 ** 9) == [fp]
    assert dest.get(fp) is None


# ============================================================ cross-package
@pytest.fixture(scope="module")
def ref_mlp():
    """The reference's golden MLP sequence (``test_torch_planner``)."""
    return capture_mlp(sizes=(64, 128, 128, 8), batch=16)[0]


@pytest.mark.parametrize("which", ["chain", "chain9", "mlp"])
def test_fingerprints_match_the_reference(which, ref_mlp):
    seq = {"chain": lambda: synthetic_chain(n_ops=12, latency=2.0, seed=0),
           "chain9": lambda: synthetic_chain(n_ops=10, latency=1.0, seed=9),
           "mlp": lambda: ref_mlp}[which]()
    port = to_port(seq)
    for dev in ("default", "d"):
        assert tc.fingerprint(port, dev) == rc.fingerprint(seq, dev)
    assert texp.sequence_signature(port) == rexp.sequence_signature(seq)


@pytest.mark.parametrize("kw", [
    {}, {"host_link_bw": 16e9, "compute_flops": 5e10, "mem_bw": 1e10},
    {"device_memory_bytes": 80 * 10 ** 9, "host_link_bw": 51.2e9,
     "compute_flops": 989e12, "mem_bw": 3.35e12}])
def test_device_identity_and_budget_bucket_match(kw):
    ref = rc.MachineProfile(**kw)
    assert tc.device_identity(port_profile(ref)) == rc.device_identity(ref)
    for b in [-5, 0, 1, 7, 1000, 123_456_789, 39_441_182_728, 80 * 10 ** 9]:
        assert tc.budget_bucket(b) == rc.budget_bucket(b)


def _strip_times(recs):
    return [{k: v for k, v in r.items() if k != "updated_at"} for r in recs]


def _read(module, store_cls, root, seq, budget, profile):
    """What one package reads from a store: fingerprints, every record
    of each entry, the device record, predicted_peak and the events and
    provenance of the plan lookup_plan returns."""
    st = store_cls(root, device_id="test-device")
    plan = st.lookup_plan(seq, "tensile", budget, profile=profile)
    dev = st.device_record()
    return {
        "fingerprints": st.fingerprints(),
        "records": {fp: module._records_of(st.get(fp))
                    for fp in st.fingerprints()},
        "device": (dataclasses.asdict(dev.calibration), dev.transfers),
        "predicted_peak": st.predicted_peak(seq),
        "bandwidth": st.bandwidth(),
        "events": [e.to_dict() for e in plan.events],
        "provenance": plan.provenance,
        "drift": [dataclasses.asdict(r)
                  for r in st.drift_history(st.fingerprint(seq))],
    }


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_store_reads_alike_in_both_packages(tmp_path, ref_mlp, writer):
    """A store one package wrote (``_populate``: plan, simulate, flush, one
    drift sample) reads the same in both: fingerprints, records,
    predicted_peak and the plan lookup_plan rebases and verifies."""
    root = str(tmp_path / writer)
    seq, port_seq = ref_mlp, to_port(ref_mlp)
    if writer == "reference":
        st = rc.ExperienceStore(root, device_id="test-device")
        budget, _ = ref_populate(st, seq)
    else:
        st = tc.ExperienceStore(root, device_id="test-device")
        budget, _ = _populate(st, port_seq)
    st.record_drift(st.fingerprint(port_seq if writer == "port" else seq),
                    rexp.DriftRecord(t=1.5, job_id="j", predicted_peak=9,
                                     measured_peak=10, peak_drift=0.1))
    st.flush()
    ref = _read(rexp, rc.ExperienceStore, root, seq, budget, REF_PROFILE)
    port = _read(texp, tc.ExperienceStore, root, port_seq, budget, PROFILE)
    assert ref == port
    assert ref["events"] and ref["predicted_peak"][1] == "experience"
    assert len(ref["drift"]) == 1


def test_both_packages_write_the_same_records(tmp_path, ref_mlp):
    """``_populate`` of each package on the same sequence writes the same
    records, the timestamps aside: the same plan, the same distilled
    telemetry of the virtual-clock simulation, the same recalibration."""
    rs = rc.ExperienceStore(str(tmp_path / "r"), device_id="test-device")
    ts = tc.ExperienceStore(str(tmp_path / "t"), device_id="test-device")
    ref_populate(rs, ref_mlp)
    _populate(ts, to_port(ref_mlp))
    assert rs.fingerprints() == ts.fingerprints()
    for fp in rs.fingerprints():
        assert _strip_times(rexp._records_of(rs.get(fp))) \
            == _strip_times(texp._records_of(ts.get(fp)))
    rd, td = rs.device_record(), ts.device_record()
    assert _strip_times([dataclasses.asdict(rd.calibration)]) \
        == _strip_times([dataclasses.asdict(td.calibration)])
    assert rd.transfers == td.transfers


def test_distill_telemetry_matches_the_reference():
    """Two hubs fed the same samples (each package's simulation of the
    same planned chain) distill to the same summary."""
    seq = synthetic_chain(n_ops=12, latency=2.0, seed=0)
    port = to_port(seq)
    rplan = rc.schedule_single(seq, profile=REF_PROFILE).plans[seq.job_id]
    tplan = tc.schedule_single(port, profile=PROFILE).plans[port.job_id]
    rhub, thub = rc.TelemetryHub(clock="virtual"), tc.TelemetryHub(
        clock="virtual")
    rc.simulate([seq], {seq.job_id: rplan}, REF_PROFILE, iterations=2,
                telemetry=rhub)
    tc.simulate([port], {port.job_id: tplan}, PROFILE, iterations=2,
                telemetry=thub)
    a = dataclasses.asdict(rexp.distill_telemetry(rhub, seq.job_id, 5))
    b = dataclasses.asdict(texp.distill_telemetry(thub, port.job_id, 5))
    a.pop("updated_at"), b.pop("updated_at")
    assert a == b and a["samples"] > 0 and a["dma"]


# ================================================================ LatencyMLP
def _samples():
    rng = np.random.default_rng(0)
    flops = 10 ** rng.uniform(6, 12, 200)
    util = rng.uniform(0, 1, 200).astype(np.float32)
    return flops, flops / 10, util, flops / 1e12 * (1 + util) + 1e-6


def _converted(hidden=16, seed=0):
    ref = rc.LatencyMLP(hidden=hidden, seed=seed)
    port = latency_mlp_from_jax(jax.tree.map(np.asarray, ref.params),
                                device="cpu")
    return ref, port


def test_latency_mlp_featurize_matches():
    flops, bts, util, _ = _samples()
    np.testing.assert_array_equal(tc.LatencyMLP.featurize(flops, bts, util),
                                  rc.LatencyMLP.featurize(flops, bts, util))


def test_converted_latency_mlp_predicts_alike():
    ref, port = _converted(hidden=32)
    flops, bts, util, lat = _samples()
    for f, b, u in zip(flops[:20], bts[:20], util[:20]):
        np.testing.assert_allclose(port.predict_one(f, b, u),
                                   ref.predict_one(f, b, u), rtol=1e-5)
    np.testing.assert_allclose(port.r2(flops, bts, util, lat),
                               ref.r2(flops, bts, util, lat), rtol=1e-5)
    with pytest.raises(KeyError):
        latency_mlp_from_jax({"w1": np.zeros((3, 4))}, device="cpu")


def test_latency_mlp_learns_monotonicity():
    """The reference's test, from the reference's seed-0 weights."""
    flops, bts, util, lat = _samples()
    _, mlp = _converted(hidden=16)
    r2 = mlp.fit(flops, bts, util, lat, steps=800)
    assert r2 > 0.9
    assert mlp.predict_one(1e12, 1e11, 0.0) > mlp.predict_one(1e8, 1e7, 0.0)


def test_latency_mlp_fit_matches_the_reference():
    """200 steps from one initialisation: R² within 1e-6, predictions
    within rtol 1e-5 (the port's AdamW is the reference's arithmetic)."""
    flops, bts, util, lat = _samples()
    ref, port = _converted(hidden=16)
    r_ref = ref.fit(flops, bts, util, lat, steps=200)
    r_port = port.fit(flops, bts, util, lat, steps=200)
    assert abs(r_ref - r_port) < 1e-6
    for f in (1e6, 1e8, 1e10, 1e12):
        np.testing.assert_allclose(port.predict_one(f, f / 10, 0.3),
                                   ref.predict_one(f, f / 10, 0.3),
                                   rtol=1e-5)


def test_latency_mlp_is_seeded_and_on_its_device():
    a, b = tc.LatencyMLP(seed=3, device="cpu"), tc.LatencyMLP(seed=3,
                                                              device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.w1, tc.LatencyMLP(seed=4, device="cpu").w1)
    assert a.w1.device.type == "cpu" and a.w1.dtype == torch.float32


def test_cost_model_latency_with_mlp_matches_the_reference():
    ref_mlp_, port_mlp_ = _converted(hidden=32, seed=1)
    ref_cm = rc.CostModel(rc.DeviceCalibration(flops=5e10, mem_bw=1e10))
    port_cm = tc.CostModel(tc.DeviceCalibration(flops=5e10, mem_bw=1e10))
    for cm in (ref_cm, port_cm):
        cm.utilization = 0.3
    plain = [port_cm.latency(f, f / 7) for f in (1e3, 1e6, 1e9, 1e12)]
    ref_cm.mlp, port_cm.mlp = ref_mlp_, port_mlp_
    for f in (1e3, 1e6, 1e9, 1e12):
        np.testing.assert_allclose(port_cm.latency(f, f / 7),
                                   ref_cm.latency(f, f / 7), rtol=1e-6)
    assert [port_cm.latency(f, f / 7) for f in (1e3, 1e6, 1e9, 1e12)] \
        != plain


# ===================================================================== tool
def test_experience_tool_lists_shows_and_round_trips(store, tmp_path,
                                                     mlp_seq):
    """``tools/experience_torch.py`` in a subprocess on a populated store:
    ``list`` names the entry and the device calibration, ``show`` prints
    its records, ``export`` then ``import`` into an empty store copies
    them."""
    _populate(store, mlp_seq)
    fp = store.fingerprint(mlp_seq)

    def tool(*args):
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools",
                                          "experience_torch.py"), *args,
             "--device", "test-device"],
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        return out.stdout

    listing = tool("list", "--dir", store.root)
    assert fp[:12] in listing and "device calibration" in listing
    shown = [json.loads(line)
             for line in tool("show", "--dir", store.root,
                              "--fingerprint", fp[:8]).splitlines()]
    assert shown == texp._records_of(store.get(fp))
    bundle = str(tmp_path / "bundle.json")
    tool("export", "--dir", store.root, "--out", bundle)
    dest = str(tmp_path / "dest")
    assert "imported 1 entries" in tool("import", "--dir", dest,
                                        "--bundle", bundle)
    copy = tc.ExperienceStore(dest, device_id="test-device")
    assert texp._records_of(copy.get(fp)) == shown
    assert copy.device_calibration() == store.device_calibration()
