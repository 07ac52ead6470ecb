"""The scheduler daemon: a long-lived event loop that owns the device.

``SchedulerDaemon`` wraps one ``GlobalController`` and accepts jobs from
independent clients over a filesystem inbox (``<root>/inbox/*.json``, one
serialized ``JobSpec`` per file — socket transport can come later; the wire
format is the spec, not the transport).  Each job moves through the durable
``JobStore``:

    QUEUED --admission--> ADMITTED --submit--> RUNNING --> DONE | FAILED
       \\--(predicted peak can never fit)--> REJECTED

Admission is the ``AdmissionQueue``: a job is admitted only when its
predicted peak (``ExperienceStore`` fingerprint for warm jobs, conservative
cost-model bound for cold ones — ``GlobalController.predict_peak``) fits the
unreserved ``BudgetArbiter`` capacity.  Reservations are refined to measured
peaks after the first profiled iteration and released on finish, both of
which can admit waiting jobs.

Crash recovery is delegated to ``JobStore.recover`` at startup: QUEUED and
ADMITTED jobs are replayed into the admission queue, RUNNING orphans are
re-queued exactly once.  A heartbeat file (``<root>/daemon.json``) lets
clients see liveness and drain progress.

A copy of the JAX package's ``service/daemon.py``.  Its default controller
is the port's ``GlobalController``, which owns the CUDA card unless
``controller_kwargs`` names another ``device`` (``{"device": "cpu"}``):
the controller resolves every job's workload on that device.  Three
departures: an attached recorder gets each ``job:<state>`` instant on the
controller hub's clock, the clock of the samples it records beside them
(the reference stamps the wall clock's epoch seconds there); it also gets
a ``capture`` and a ``predict`` span (category ``admission``) on a job's
track for each admission step, the capture's with the cost model's
iteration time and the prediction's with its peak and source; and the
daemon hands a job's capture to the controller at submission and keeps
no reference to it (the port's controller donates the state to its
executors, which free what the plan frees only if nothing else holds it).
"""

from __future__ import annotations

import json
import os
import threading
import time as _time
from typing import Any, Dict, List, Optional

from ..core.multiplexer import CapturedJob, GlobalController
from ..obs.metrics import MetricsRegistry
from .jobspec import JobSpec, JobState
from .queue import AdmissionQueue
from .store import JobRecord, JobStore

INBOX_DIR = "inbox"
HEARTBEAT_FILE = "daemon.json"
METRICS_FILE = "metrics.prom"
CONTROL_PREFIX = "ctl-"


class SchedulerDaemon:
    """Event loop around a ``GlobalController`` with admission control.

    ``controller`` is injectable for tests (anything with ``capture_spec``,
    ``predict_peak`` and ``submit``); by default a real ``GlobalController``
    is built from ``controller_kwargs`` owning the device (``device``:
    the CUDA card by default; a missing card raises), with an
    ``ExperienceStore`` under ``<root>/experience`` so admission
    predictions warm up across runs.
    """

    def __init__(self, root: str,
                 controller: Optional[Any] = None,
                 capacity_bytes: Optional[int] = None,
                 poll_interval: float = 0.05,
                 controller_kwargs: Optional[Dict[str, Any]] = None):
        self.root = root
        self.inbox = os.path.join(root, INBOX_DIR)
        os.makedirs(self.inbox, exist_ok=True)
        if controller is None:
            kwargs = dict(controller_kwargs or {})
            kwargs.setdefault("arbiter_policy", "priority")
            kwargs.setdefault("experience_dir",
                              os.path.join(root, "experience"))
            if capacity_bytes is not None:
                kwargs.setdefault("device_capacity", capacity_bytes)
            controller = GlobalController(**kwargs)
        self.controller = controller
        if capacity_bytes is None:
            arb = getattr(controller, "arbiter", None)
            if arb is not None:
                capacity_bytes = arb.capacity
            else:
                capacity_bytes = controller.profile.device_memory_bytes
        self.capacity_bytes = int(capacity_bytes)
        self.store = JobStore(root)
        self.queue = AdmissionQueue(self.capacity_bytes)
        self.poll_interval = poll_interval
        # job_id -> CapturedJob (capture happens once, pre-admission)
        self._captured: Dict[str, CapturedJob] = {}
        self._handles: Dict[str, Any] = {}
        self._refined: set = set()
        self._draining = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # observability: a Prometheus-style registry written next to the
        # heartbeat every tick, plus an optional trace recorder for
        # state-transition instants (None = zero overhead)
        self.metrics = MetricsRegistry()
        self.metrics_path = os.path.join(root, METRICS_FILE)
        self.recorder = None
        self._transitions = self.metrics.counter(
            "tensile_state_transitions_total",
            "job state transitions since daemon start")
        self._last_metrics = 0.0
        self.recovered = self.recover()

    def attach_recorder(self, recorder) -> None:
        """Forward state-transition instants to a trace recorder."""
        self.recorder = recorder

    def _transition(self, job_id: str, state: JobState, now: float,
                    **kw) -> None:
        """``JobStore.transition`` + the observability fan-out: every
        state change bumps the transitions counter and (with a recorder
        attached) lands as an instant event on the trace timeline."""
        self.store.transition(job_id, state, now, **kw)
        self._transitions.inc(state=state.value)
        if self.recorder is not None:
            self.recorder.instant(f"job:{state.value}", self._trace_time(now),
                                  job_id=job_id)

    def _trace_time(self, now: float) -> float:
        """A transition's time on the trace: the controller hub's clock,
        which its executors' samples carry, so one trace holds both on one
        axis (the store keeps the wall-clock ``now``).  Without a hub,
        ``now``."""
        hub = getattr(self.controller, "telemetry", None)
        return hub.now() if hub is not None else now

    def _admission_mark(self, now: float):
        """Where an admission step starts: the trace's time and a
        ``perf_counter`` reading; None without a recorder."""
        if self.recorder is None:
            return None
        return self._trace_time(now), _time.perf_counter()

    def _admission_span(self, name: str, job_id: str, mark,
                        **args) -> None:
        """An admission step (``capture`` or ``predict``) from ``mark``
        to now as a span on the job's track (none without a recorder)."""
        if mark is not None:
            start, t0 = mark
            self.recorder.span(name, start, _time.perf_counter() - t0,
                               job_id=job_id, cat="admission", **args)

    # -- crash recovery ------------------------------------------------------

    def recover(self) -> Dict[str, List[str]]:
        """Replay the durable store into the live queue (startup)."""
        now = _time.time()
        replayed, requeued, failed = self.store.recover(now)
        for rec in sorted(self.store.by_state(JobState.QUEUED),
                          key=lambda r: r.submitted_at):
            self._enqueue(rec, now)
        return {"replayed": replayed, "requeued_orphans": requeued,
                "failed_orphans": failed}

    # -- submission ----------------------------------------------------------

    def submit(self, spec: JobSpec) -> JobRecord:
        """In-process submission (the inbox path funnels here).  ``job_id``
        is the idempotency key: re-submitting a known, non-terminal job is
        a no-op returning the existing record."""
        now = _time.time()
        existing = self.store.get(spec.job_id)
        if existing is not None and not existing.state.terminal:
            return existing
        rec = JobRecord(spec=spec, state=JobState.QUEUED, submitted_at=now)
        self.store.put(rec, now)
        self._enqueue(rec, now)
        return rec

    def _enqueue(self, rec: JobRecord, now: float) -> None:
        """Predict the job's peak and push it into the admission queue.
        Unresolvable workloads and never-fitting peaks become REJECTED —
        a bad submission must not take the daemon down."""
        spec = rec.spec
        try:
            captured = self._captured.get(spec.job_id)
            if captured is None:
                mark = self._admission_mark(now)
                captured = self.controller.capture_spec(spec)
                self._captured[spec.job_id] = captured
                self._admission_span(
                    "capture", spec.job_id, mark,
                    iteration_s=getattr(captured.seq, "iteration_time",
                                        None))
            mark = self._admission_mark(now)
            predicted, source = self.controller.predict_peak(
                captured.seq, budget_hint_bytes=spec.budget_hint_bytes)
            self._admission_span("predict", spec.job_id, mark,
                                 peak_bytes=int(predicted), source=source)
            rec.predicted_peak_bytes = int(predicted)
            rec.predicted_source = source
            self.queue.push(spec.job_id, predicted,
                            priority=spec.priority or 1.0,
                            source=source, enqueued_at=now)
            self.store.put(rec, now)
        except ValueError as exc:
            self._transition(spec.job_id, JobState.REJECTED, now,
                             error=str(exc))
            self._captured.pop(spec.job_id, None)
        except Exception as exc:  # noqa: BLE001 - capture blew up
            self._transition(spec.job_id, JobState.FAILED, now,
                             error=f"capture failed: {exc}")
            self._captured.pop(spec.job_id, None)

    # -- event loop ----------------------------------------------------------

    def step(self, now: Optional[float] = None) -> int:
        """One tick: drain the inbox, poll running jobs, admit what fits.
        Returns the number of state changes (0 == idle tick)."""
        now = _time.time() if now is None else now
        changes = self._drain_inbox(now)
        changes += self._poll_running(now)
        changes += self._try_admit(now)
        self._write_heartbeat(now)
        return changes

    def _drain_inbox(self, now: float) -> int:
        changes = 0
        try:
            names = sorted(os.listdir(self.inbox))
        except OSError:
            return 0
        for name in names:
            if not name.endswith(".json"):
                continue  # client temp files (.json.tmp.*) are invisible
            path = os.path.join(self.inbox, name)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    data = json.load(f)
            except (OSError, ValueError):
                # half-written or corrupt submissions: skip, never crash;
                # the file is removed so it cannot wedge the inbox forever
                self._unlink(path)
                continue
            if name.startswith(CONTROL_PREFIX):
                if isinstance(data, dict) and data.get("control") == "drain":
                    self._draining = True
                    changes += 1
                self._unlink(path)
                continue
            try:
                spec = JobSpec.from_dict(data)
            except ValueError:
                self._unlink(path)
                continue
            # persist-then-unlink: a crash in between re-submits the same
            # job_id, which the store dedupes (idempotency key)
            self.submit(spec)
            self._unlink(path)
            changes += 1
        return changes

    def _poll_running(self, now: float) -> int:
        changes = 0
        for rec in self.store.by_state(JobState.RUNNING):
            jid = rec.job_id
            handle = self._handles.get(jid)
            if handle is None:
                continue  # recovered-orphan bookkeeping already handled
            if handle.done:
                measured = int(getattr(handle, "peak_bytes", 0) or 0)
                self.queue.release(jid)
                self._captured.pop(jid, None)
                self._handles.pop(jid, None)
                if getattr(handle, "error", None) is not None:
                    self._transition(jid, JobState.FAILED, now,
                                     measured_peak_bytes=measured,
                                     error=repr(handle.error))
                else:
                    self._transition(jid, JobState.DONE, now,
                                     measured_peak_bytes=measured)
                changes += 1
            elif jid not in self._refined and len(handle.stats) >= 1:
                # first profiled iteration: refine the reservation from the
                # measured peak — a shrunken conservative bound frees
                # headroom for waiting jobs at the next admission pass
                measured = int(getattr(handle, "peak_bytes", 0) or 0)
                if measured > 0:
                    self.queue.refine(jid, measured)
                    self._refined.add(jid)
                    rec.measured_peak_bytes = measured
                    self.store.put(rec, now)
                    changes += 1
        return changes

    def _try_admit(self, now: float) -> int:
        changes = 0
        for job in self.queue.pop_admissible(now):
            rec = self.store.get(job.job_id)
            if rec is None:
                self.queue.release(job.job_id)
                continue
            self._transition(job.job_id, JobState.ADMITTED, now)
            try:
                # the capture goes to the controller, which donates the
                # job's state to its executors: kept here, it would hold
                # the memory the plan frees
                handle = self.controller.submit(
                    rec.spec, captured=self._captured.pop(job.job_id, None))
            except Exception as exc:  # noqa: BLE001 - admission stays up
                self.queue.release(job.job_id)
                self._transition(job.job_id, JobState.FAILED, now,
                                 error=f"submit failed: {exc}")
                changes += 1
                continue
            self._handles[job.job_id] = handle
            self._transition(job.job_id, JobState.RUNNING, now)
            changes += 1
        return changes

    # -- lifecycle -----------------------------------------------------------

    @property
    def idle(self) -> bool:
        """No queued, admitted, or running work left."""
        return not self.store.by_state(JobState.QUEUED, JobState.ADMITTED,
                                       JobState.RUNNING)

    def serve_forever(self) -> None:
        """Run until stopped — or, when draining, until the queue is empty."""
        while not self._stop.is_set():
            busy = self.step()
            if self._draining and self.idle:
                break
            if not busy:
                self._stop.wait(self.poll_interval)
        self._write_heartbeat(_time.time(), state="stopped")

    def start(self) -> "SchedulerDaemon":
        """Run the event loop on a background thread."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def drain(self, timeout: float = 300.0) -> bool:
        """Finish everything queued/running, then stop.  True on empty."""
        self._draining = True
        deadline = _time.time() + timeout
        if self._thread is None:
            while not self.idle and _time.time() < deadline:
                self.step()
                _time.sleep(self.poll_interval)
        else:
            self._thread.join(max(0.0, deadline - _time.time()))
        done = self.idle
        self.stop()
        # final heartbeat: the threaded loop writes its own on exit, the
        # in-process path needs one here so the last metrics refresh (an
        # unthrottled `state` write) reflects the drained store
        if self._thread is None:
            self._write_heartbeat(_time.time(), state="stopped")
        return done

    # -- observability -------------------------------------------------------

    def _write_heartbeat(self, now: float, state: Optional[str] = None) -> None:
        hb = {"pid": os.getpid(), "updated_at": now,
              "state": state or ("draining" if self._draining else "running"),
              "capacity_bytes": self.capacity_bytes,
              "reserved_bytes": self.queue.reserved_bytes,
              "waiting": len(self.queue)}
        tmp = os.path.join(self.root, HEARTBEAT_FILE + ".tmp")
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(hb, f, sort_keys=True)
            os.replace(tmp, os.path.join(self.root, HEARTBEAT_FILE))
        except OSError:
            pass  # heartbeat is best-effort observability
        # the Prometheus exposition rides the heartbeat, throttled so
        # gauge derivation stays off the per-tick hot path
        if now - self._last_metrics >= 0.5 or state is not None:
            self._last_metrics = now
            try:
                self._refresh_metrics(now)
                self.metrics.write(self.metrics_path)
            except OSError:
                pass  # same best-effort contract as the heartbeat

    def _refresh_metrics(self, now: float) -> None:
        """Re-derive every gauge from live daemon + controller state."""
        m = self.metrics
        m.gauge("tensile_queue_depth",
                "jobs waiting for admission").set(len(self.queue))
        m.gauge("tensile_capacity_bytes",
                "device byte budget admission reserves against").set(
                    self.capacity_bytes)
        m.gauge("tensile_reserved_bytes",
                "bytes currently reserved by admitted/running jobs").set(
                    self.queue.reserved_bytes)
        jobs = m.gauge("tensile_jobs", "jobs per lifecycle state")
        jobs.clear()
        errs = []
        for rec in self.store.all().values():
            jobs.inc(state=rec.state.value)
            p = rec.predicted_peak_bytes
            meas = rec.measured_peak_bytes
            if p and meas:
                errs.append(abs(p - meas) / meas)
        if errs:
            m.gauge("tensile_admission_precision_ratio",
                    "mean |predicted - measured| / measured peak over "
                    "profiled jobs").set(sum(errs) / len(errs))
        ctl = self.controller
        m.gauge("tensile_replan_count",
                "controller replans since start").set(
                    getattr(ctl, "replan_count", 0))
        m.gauge("tensile_preempt_count",
                "mid-iteration preemptive hot-swap requests").set(
                    getattr(ctl, "preempt_count", 0))
        handles = getattr(ctl, "jobs", None) or {}
        hot = 0
        tps = m.gauge("tensile_serve_tokens_per_sec",
                      "decode throughput of the latest serve report")
        for jid, h in handles.items():
            for st in getattr(h, "stats", []) or []:
                hot += getattr(st, "hot_swaps", 0) or 0
            for st in reversed(getattr(h, "stats", []) or []):
                rate = getattr(st, "tokens_per_s", None)
                if rate is not None:
                    tps.set(rate, job=jid)
                    break
        m.gauge("tensile_hot_swap_count",
                "plan hot-swaps applied by executors").set(hot)
        fails = getattr(ctl, "experience_failures", None)
        if fails is not None:
            m.gauge("tensile_experience_failures",
                    "experience-store operations that failed").set(
                        len(fails))
        events = getattr(ctl, "events", None)
        if events is not None:
            m.gauge("tensile_warn_events",
                    "WARN/ERROR events in the controller event log").set(
                        len(events.warnings()))
        hub = getattr(ctl, "telemetry", None)
        cm = getattr(ctl, "cost_model", None)
        if hub is not None and cm is not None:
            try:
                if hub.jobs():
                    rep = cm.calibration_report(hub)
                    if rep.samples:
                        m.gauge("tensile_calib_err",
                                "mean relative cost-model latency "
                                "error").set(rep.overall)
            except Exception:  # noqa: BLE001 - metrics must not crash
                pass

    def status(self) -> Dict[str, Any]:
        counts: Dict[str, int] = {}
        for rec in self.store.all().values():
            counts[rec.state.value] = counts.get(rec.state.value, 0) + 1
        return {"capacity_bytes": self.capacity_bytes,
                "reserved_bytes": self.queue.reserved_bytes,
                "max_reserved_bytes": self.queue.max_reserved_bytes,
                "waiting": len(self.queue),
                "draining": self._draining,
                "jobs": counts}

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass
