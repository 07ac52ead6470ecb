"""The port's observability plane (``repro_torch.obs``: the metrics
registry and the drift monitor) against the JAX package's, on the CPU.

The cases are the metrics and drift cases of ``tests/test_obs.py`` run on
the port, each beside the reference fed the same calls: both registries
must render the same Prometheus text, both monitors the same samples and
WARN events.  Everything here is plain Python arithmetic on the same
inputs, so every comparison is exact.  The controller cases check the
hooks that feed the monitor and the store (``core/multiplexer.py``).
"""
import dataclasses

import numpy as np
import pytest

import repro.core as rc
from repro.obs import DriftMonitor as RefDriftMonitor
from repro.obs import EventLog as RefEventLog
from repro.obs import MetricsRegistry as RefMetricsRegistry
from repro.obs import parse_metrics_text as ref_parse
from helpers import synthetic_chain
import repro_torch.core as tc
from repro_torch.obs import (DriftMonitor, EventLog, MetricsRegistry,
                             parse_metrics_text)
from repro_torch.service import JobSpec, make_mlp
from test_torch_planner import port_profile, to_port

PROFILE = port_profile(rc.MachineProfile(host_link_bw=16e9,
                                         compute_flops=5e10, mem_bw=1e10))
PORT = (MetricsRegistry, DriftMonitor, EventLog, parse_metrics_text,
        tc.ExperienceStore)
REF = (RefMetricsRegistry, RefDriftMonitor, RefEventLog, ref_parse,
       rc.ExperienceStore)


def _fill(registry):
    reg = registry()
    reg.counter("tensile_test_total", "a counter").inc(job="a")
    reg.counter("tensile_test_total").inc(job="a")
    reg.gauge("tensile_test_bytes", "a gauge").set(1.5e6, job="a")
    reg.gauge("tensile_test_ratio").set(0.125, job="b")
    reg.histogram("tensile_test_seconds", "a histogram",
                  buckets=(0.1, 1.0)).observe(0.5)
    return reg


# ---------------------------------------------------------------- metrics
def test_metrics_render_parse_round_trip():
    reg = _fill(MetricsRegistry)
    text = reg.render_text()
    assert text == _fill(RefMetricsRegistry).render_text()
    parsed = parse_metrics_text(text)
    assert parsed == ref_parse(text)
    assert parsed[("tensile_test_total", (("job", "a"),))] == 2
    assert parsed[("tensile_test_bytes", (("job", "a"),))] == 1.5e6
    assert parsed[("tensile_test_seconds_bucket", (("le", "0.1"),))] == 0
    assert parsed[("tensile_test_seconds_bucket", (("le", "1"),))] == 1
    assert parsed[("tensile_test_seconds_bucket", (("le", "+Inf"),))] == 1
    assert parsed[("tensile_test_seconds_count", ())] == 1
    assert parsed[("tensile_test_seconds_sum", ())] == 0.5


def test_metrics_registry_idempotent_typed_and_written(tmp_path):
    reg = MetricsRegistry()
    c = reg.counter("tensile_x_total")
    assert reg.counter("tensile_x_total") is c
    with pytest.raises(TypeError):
        reg.gauge("tensile_x_total")
    path = tmp_path / "m" / "metrics.prom"
    text = _fill(MetricsRegistry).write(str(path))
    assert path.read_text() == text
    assert not [p for p in path.parent.iterdir() if p.suffix == ".tmp"]


@pytest.mark.parametrize("text", ["tensile_x{job=a} 1\n",
                                  "tensile_x not_a_number\n",
                                  "# only comments\n",
                                  'tensile_x{job="a" 1\n'])
def test_parse_rejects_malformed_text(text):
    with pytest.raises(ValueError):
        parse_metrics_text(text)
    with pytest.raises(ValueError):
        ref_parse(text)


# ----------------------------------------------------------------- drift
def _threshold_case(pkg):
    registry, monitor, events, _, _ = pkg
    log, reg = events(clock=lambda: 0.0), registry()
    mon = monitor(threshold=0.15, events=log, metrics=reg,
                  clock=lambda: 0.0)
    ok = mon.observe("fp-quiet", predicted_peak=100, measured_peak=100,
                     predicted_safe_points=[1, 2],
                     measured_safe_points=[1, 2])
    bad = mon.observe("fp-loud", predicted_peak=200, measured_peak=100,
                      job_id="j")
    return mon, log, reg, ok, bad


def test_drift_monitor_threshold_and_metrics():
    mon, log, reg, ok, bad = _threshold_case(PORT)
    assert ok.worst == 0.0
    assert bad.peak_drift == 1.0
    warns = log.events(level="WARN", source="drift")
    assert len(warns) == 1 and warns[0].args["fingerprint"] == "fp-loud"
    assert reg.gauge("tensile_drift_peak_ratio").value(
        fingerprint="fp-loud") == 1.0
    assert [s.fingerprint for s in mon.over_threshold()] == ["fp-loud"]
    assert mon.worst_drift() == 1.0
    assert len(mon.history("fp-quiet")) == 1
    # the reference fed the same calls: the same samples, event, metrics
    rmon, rlog, rreg, rok, rbad = _threshold_case(REF)
    assert dataclasses.asdict(ok) == dataclasses.asdict(rok)
    assert dataclasses.asdict(bad) == dataclasses.asdict(rbad)
    assert [(e.level, e.source, e.message, e.args) for e in log.events()] \
        == [(e.level, e.source, e.message, e.args) for e in rlog.events()]
    assert reg.render_text() == rreg.render_text()


def test_drift_safe_point_axis():
    for monitor in (DriftMonitor, RefDriftMonitor):
        mon = monitor(threshold=0.15)
        s = mon.observe("fp", predicted_peak=100, measured_peak=100,
                        predicted_safe_points=[1, 2, 3],
                        measured_safe_points=[4, 5, 6])
        assert s.sp_drift == 1.0 and s.worst == 1.0
        s2 = mon.observe("fp", predicted_peak=100, measured_peak=100,
                         predicted_safe_points=None,
                         measured_safe_points=None)
        assert s2.sp_drift is None and s2.worst == 0.0
        assert mon.observe("fp", predicted_peak=0,
                           measured_peak=0).peak_drift == 0.0
        assert mon.observe("fp", predicted_peak=3,
                           measured_peak=0).peak_drift == 1.0


@pytest.mark.parametrize("reader", ["port", "reference"])
def test_drift_history_persists_across_store_reopen(tmp_path, reader):
    """The port's monitor writes the history into the port's store; a
    reopened store of either package reads the same record."""
    chain = synthetic_chain(n_ops=4)
    exp = tc.ExperienceStore(str(tmp_path), device_id="test-device")
    fp = exp.fingerprint(to_port(chain))
    mon = DriftMonitor(experience=exp, clock=lambda: 7.0)
    mon.observe(fp, predicted_peak=120, measured_peak=100, job_id="j",
                predicted_eor=0.1, measured_eor=0.2,
                predicted_safe_points=[3], measured_safe_points=[3])
    exp.flush()
    store = (tc.ExperienceStore if reader == "port" else rc.ExperienceStore)
    hist = store(str(tmp_path), device_id="test-device").drift_history(fp)
    assert len(hist) == 1
    rec = hist[0]
    assert rec.predicted_peak == 120 and rec.measured_peak == 100
    assert rec.peak_drift == pytest.approx(0.2)
    assert rec.eor_drift == pytest.approx(0.5)
    assert rec.sp_drift == 0.0
    assert rec.t == 7.0


# ------------------------------------------------- controller visibility
def test_experience_flush_failure_is_visible_event():
    """A failing store on job exit is recorded and surfaces as a WARN
    event; it never raises out of the job's departure."""

    class ExplodingStore:
        def fingerprint(self, seq):
            return "fp"

        def record_job(self, *a, **kw):
            raise IOError("disk full")

        def flush(self):
            raise AssertionError("flush unreachable: record_job raised")

    seq = to_port(synthetic_chain(n_ops=4, job_id="doomed"))
    ctl = tc.GlobalController(profile=PROFILE, device="cpu")
    ctl.experience = ExplodingStore()
    handle = tc.JobHandle(job_id="doomed", seq=seq, graph_module=None,
                          args=(), iterations=1, fingerprint="fp")
    ctl._on_job_exit(handle)
    assert [j for j, _ in ctl.experience_failures] == ["doomed"]
    warns = ctl.events.events(level="WARN", source="experience")
    assert len(warns) == 1
    assert warns[0].args["job_id"] == "doomed"
    assert "disk full" in warns[0].args["error"]


def test_controller_feeds_the_drift_monitor(tmp_path):
    """A cold job's admission-time prediction (the no-free bound) against
    its measured peak: one sample per job, a WARN past the threshold, the
    gauge set, the history in the store; the second run predicts from the
    store and drifts less."""
    root = str(tmp_path / "exp")
    samples = []
    for run in range(2):
        events, metrics = EventLog(), MetricsRegistry()
        ctl = tc.GlobalController(profile=PROFILE, experience_dir=root,
                                  async_swap=False, device="cpu",
                                  events=events)
        ctl.drift = DriftMonitor(experience=ctl.experience, events=events,
                                 metrics=metrics)
        spec = JobSpec(f"run{run}", iterations=1,
                       payload=make_mlp((12, 24, 6), 4, device="cpu"))
        cap = ctl.capture_spec(spec)
        source = ctl.predict_peak(cap.seq)[1]
        h = ctl.submit(spec, cap)
        ctl.wait(timeout=120)
        assert not ctl.experience_failures
        sample = ctl.drift.last(h.fingerprint)
        assert sample.predicted_peak == h.predicted_peak
        assert sample.measured_peak == max(h.peak_bytes,
                                           ctl.accountant.job_peak(h.job_id))
        samples.append((source, sample, events.warnings(), metrics))
    (src0, cold, warn0, m0), (src1, warm, warn1, _) = samples
    assert (src0, src1) == ("cost-model", "experience")
    assert cold.peak_drift > 0.15 and [w.source for w in warn0] == ["drift"]
    assert warm.peak_drift < cold.peak_drift and not warn1
    assert m0.gauge("tensile_drift_peak_ratio").value(
        fingerprint=cold.fingerprint[:12]) == cold.peak_drift
    hist = tc.ExperienceStore(root).drift_history(cold.fingerprint)
    assert [r.job_id for r in hist] == ["run0", "run1"]


class SeededHub(tc.TelemetryHub):
    """A hub whose measured latencies are drawn from a numpy seed, in place
    of the wall clock's: each operator's capture-time latency times
    10 ** U(0, 3) (a loaded host), the same draws for every query."""

    def __init__(self, seed: int):
        super().__init__(clock="real")
        self.rng = np.random.default_rng(seed)
        self.capture_latencies = {}
        self.drawn = {}

    def op_latencies(self, job_id):
        measured = super().op_latencies(job_id)
        if job_id not in self.drawn:
            base = self.capture_latencies[job_id]
            self.drawn[job_id] = {i: base[i] * 10 ** self.rng.uniform(0, 3)
                                  for i in sorted(measured)}
        return dict(self.drawn[job_id])

    def latency_sum(self, job_id):
        return sum(self.op_latencies(job_id).values())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warm_run_keeps_the_cold_plan_under_drifting_latencies(tmp_path,
                                                               seed):
    """The drift case above with measured latencies drawn from a seed
    instead of the wall clock.  After a job's last iteration a drift
    replan would make a plan that never runs, which the store would hand
    the warm run beside the peak the plan before it produced (warm drift
    0.20-0.73 with a WARN on these seeds).  A job whose plan kept to its
    slice keeps that plan instead: the warm run, booted from it, measures
    exactly the peak the store predicts."""
    root = str(tmp_path / "exp")
    runs = []
    for run in range(2):
        events = EventLog()
        hub = SeededHub(2 * seed + run)
        ctl = tc.GlobalController(profile=PROFILE, experience_dir=root,
                                  async_swap=False, device="cpu",
                                  events=events, telemetry=hub)
        ctl.drift = DriftMonitor(experience=ctl.experience, events=events,
                                 metrics=MetricsRegistry())
        spec = JobSpec(f"run{run}", iterations=1,
                       payload=make_mlp((12, 24, 6), 4, device="cpu"))
        cap = ctl.capture_spec(spec)
        hub.capture_latencies[spec.job_id] = [
            op.latency for op in cap.seq.operators]
        h = ctl.submit(spec, cap)
        ctl.wait(timeout=120)
        runs.append((ctl.drift.last(h.fingerprint), events.warnings(),
                     ctl.replan_count))
    (cold, warn0, n0), (warm, warn1, n1) = runs
    assert [w.source for w in warn0] == ["drift"]
    assert warm.predicted_peak == cold.measured_peak
    assert warm.measured_peak == cold.measured_peak
    assert warm.peak_drift == 0.0 and not warn1
    # the hub reports drift past the threshold, yet no replan followed
    # the only iteration
    assert hub.drift_ratio(spec.job_id, sum(
        hub.capture_latencies[spec.job_id])) > \
        ctl.scheduler.config.update_threshold
    assert n0 == n1 == 1
