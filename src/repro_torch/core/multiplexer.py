"""Global Controller (paper §III-D, Fig. 3) and cross-job budget arbitration
on one CUDA card.

The port of the JAX package's ``core/multiplexer.py``.  The controller owns
the job registry of a device: it runs each job's ``FxExecutor`` iterations
on a thread of its own, funnels measured operator latencies back to the
Memory Scheduler, re-plans when latencies drift past the update threshold
(§IV-E), and hands out fresh plans, which each job applies at its next
iteration boundary ("the system will apply the new plan right before
computing the next batch of data").

The four-step procedure of §III-D:
  1. ``capture_spec``/``submit`` -- capture the new job's graph
     (``capture_train_step``: an aten graph module and its access
     sequence) with cold-start latencies from the cost model;
  2. ``_replan``   -- the Memory Scheduler plans every live job;
  3. executor threads and the shared channel run the plans;
  4. latency reports -- EWMA-folded from the telemetry hub; drift beyond
     the threshold triggers 2.

Beyond the paper: the ``BudgetArbiter`` splits the device-wide byte budget
across live jobs by a pluggable policy (equal, priority, peak demand,
measured stall share) at every arrival, departure and drift replan, and
each job plans against its slice.  In arbiter mode ``"preempt"`` a shrunken
slice also takes effect mid-iteration: the controller builds a remainder
plan (``MemoryScheduler.replan_from``) and the victim's running executor
splices it in at its next safe point (``FxExecutor.request_plan``).

On a card every job's iterations run on a CUDA stream of their own (a job
waiting for its prefetch must not stall the others), and every job's
transfers go onto one copy stream, the device channel's, so the card
orders them as the channel books them (paper Fig. 4).  A serving job
(``JobSpec.kind == "serve"``) runs ``ServingEngine.serve`` against the
shared ledger and channel under its slice, with the batched transfer path
(one KV gather and one scatter launch per cohort).

The experience plane (``experience``/``experience_dir``, an
``ExperienceStore``, ``core/experience.py``) warm-boots a recurring job: the
cost model starts from the persisted calibration, ``predict_peak`` returns
the peak a prior run measured, the pipeline adopts a stored plan once it
re-verifies against the job's budget, and the arbiter's ``peak`` and
``eor-learned`` policies read the stored telemetry as priors; each train
job's distilled run is flushed back at its exit.  An attached
``DriftMonitor`` (``obs/drift.py``) compares the peak predicted at
admission with the measured one at exit.  A failing store never takes a
job down: its errors go to ``experience_failures`` and WARN events.

With ``hold_slices=True`` (off by default, as in the reference) each
train job's executor gets the job's slice as its budget
(``FxExecutor(budget_bytes=...)``): where the planner returns a plan over
the slice, or a plan's model misjudges the card, the executor waits for
its swap-outs or swaps out more itself rather than exceed the slice.  A
split that shrinks the slice reaches the running executor's guard at
once, so an arrival cannot push the device over its capacity while an
earlier job finishes an iteration planned for a larger slice; the guard
is never set below what one of that iteration's operators must hold at
once (``FxExecutor.operator_floor``), so the running job finishes its
iteration over the larger of the two.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time as _time
import traceback
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from ..device import resolve_device
from ..obs.events import EventLog
from .access import AccessSequence
from .cost_model import CostModel
from .engine import (DeviceLedger, DmaChannel, JobLedgerView, MemoryEngine,
                     find_safe_points)
from .executor import FxExecutor
from .experience import ExperienceStore, device_identity
from .graph_capture import capture_train_step
from .peak_analysis import analyze
from .plan import MachineProfile, SchedulingPlan
from .scheduler import MemoryScheduler, SchedulerConfig
from .telemetry import TelemetryHub


class JobFailedError(RuntimeError):
    """One or more job threads died.  Carries every failed handle so a
    multi-job failure is reported whole, each job's traceback in the
    message; the first underlying exception is chained as ``__cause__``."""

    def __init__(self, failures: Dict[str, BaseException],
                 tracebacks: Optional[Dict[str, str]] = None):
        self.failures = dict(failures)
        self.tracebacks = dict(tracebacks or {})
        detail = "; ".join(
            f"{j}: {type(e).__name__}: {e}" for j, e in self.failures.items())
        tbs = "".join(f"\n--- {j} ---\n{tb}"
                      for j, tb in self.tracebacks.items())
        super().__init__(
            f"{len(self.failures)} job(s) failed — {detail}{tbs}")


@dataclasses.dataclass
class JobHandle:
    job_id: str
    seq: AccessSequence
    graph_module: Any
    # a train job's (params, opt_state, batch): the state it started from,
    # and after each iteration the state it reached (held by the executor
    # while an iteration runs); a serve job's (engine, requests)
    args: tuple
    iterations: int
    priority: float = 1.0
    thread: Optional[threading.Thread] = None
    plan: Optional[SchedulingPlan] = None
    plan_version: int = 0
    done: bool = False
    error: Optional[BaseException] = None
    error_tb: Optional[str] = None
    stats: List[Any] = dataclasses.field(default_factory=list)
    step_times: List[float] = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    # the arbiter-assigned slice of the device budget, as a live view over
    # the shared DeviceLedger (None until the first split)
    ledger_view: Optional[JobLedgerView] = None
    # structural fingerprint (the experience store's, else the spec's)
    fingerprint: Optional[str] = None
    # the admission-time peak prediction, pinned at submit when a drift
    # monitor is attached (compared with the measured peak at exit)
    predicted_peak: Optional[int] = None
    # the executor running (or last to run) this job's iteration -- the
    # preemptive arbiter hot-swaps plans into it at a safe point
    executor: Optional[Any] = None
    # (plan_version, safe_op) of every preemptive hot-swap requested
    preemptions: List[Any] = dataclasses.field(default_factory=list)
    # the JobSpec this handle was submitted with
    spec: Optional[Any] = None
    # a train job's last step metrics (outputs after params and opt-state);
    # a serve job's generated token ids per request
    outputs: Any = None

    @property
    def budget_bytes(self) -> Optional[int]:
        return self.ledger_view.budget_bytes if self.ledger_view else None


def _is_serve(handle: JobHandle) -> bool:
    """Serve handles are told apart by their spec's ``kind``: handles built
    outside submit() may carry no graph and still be training jobs."""
    return (handle.spec is not None
            and getattr(handle.spec, "kind", "train") == "serve")


def _within_budget(plan: Optional[SchedulingPlan]) -> bool:
    """Whether a plan certified a peak within the budget it was built
    against (0: none recorded)."""
    return plan is not None and (not plan.budget_bytes
                                 or plan.planned_peak_bytes
                                 <= plan.budget_bytes)


@dataclasses.dataclass
class CapturedJob:
    """A JobSpec resolved and captured: everything admission and submit
    need (``capture_spec``), so a caller can predict a job's peak before
    it commits to ``submit``."""

    seq: AccessSequence
    graph_module: Any
    args: Tuple[Any, ...]
    fingerprint: Optional[str] = None


# ----------------------------------------------------------------------
# Budget arbitration (device-wide budget -> per-job slices)
# ----------------------------------------------------------------------
def _equal_weights(arb: "BudgetArbiter", live: Sequence[str]
                   ) -> Dict[str, float]:
    return {j: 1.0 for j in live}


def _priority_weights(arb: "BudgetArbiter", live: Sequence[str]
                      ) -> Dict[str, float]:
    return {j: max(arb.priorities.get(j, 1.0), 1e-9) for j in live}


def _peak_weights(arb: "BudgetArbiter", live: Sequence[str]
                  ) -> Dict[str, float]:
    """Proportional to each job's peak demand: the measured peak once the
    job has one, else an attached prior's peak, else the predicted
    no-free peak from capture."""
    out: Dict[str, float] = {}
    for j in live:
        w = arb.demands.get(j, 0)
        prior = arb.priors.get(j)
        if prior is not None and prior.peak_bytes \
                and j not in arb.live_peak_seen:
            w = prior.peak_bytes
        out[j] = float(max(w, 1))
    return out


# how strongly a job's measured stall share bids for extra bytes under
# the eor-learned policy: weight = 1 + GAIN * stall_share, in [1, 1+GAIN]
EOR_LEARNED_GAIN = 3.0


def _eor_learned_weights(arb: "BudgetArbiter", live: Sequence[str]
                         ) -> Dict[str, float]:
    """A job losing more of its measured time to memory stalls (passive
    swap-ins, late prefetches) bids for more bytes in proportion to its
    measured stall share; a job without samples bids an attached prior's
    share, else the neutral weight."""
    hub = arb.telemetry
    out: Dict[str, float] = {}
    for j in live:
        share = None
        if hub is not None and hub.has_samples(j):
            share = hub.stall_share(j)
        if share is None:
            prior = arb.priors.get(j)
            share = prior.stall_share if prior is not None else 0.0
        out[j] = 1.0 + EOR_LEARNED_GAIN * share
    return out


ARBITER_POLICIES: Dict[str, Callable[["BudgetArbiter", Sequence[str]],
                                     Dict[str, float]]] = {
    "equal": _equal_weights,
    "priority": _priority_weights,
    "peak": _peak_weights,
    "eor-learned": _eor_learned_weights,
}


ARBITER_MODES = ("boundary", "preempt")


class BudgetArbiter:
    """Owns the device-wide byte budget and splits it across live jobs.

    ``split(live)`` runs weighted water-filling: each job's raw share is
    ``capacity * w_j / sum(w)``; a job whose known demand (its no-free
    peak: it can never use more) is below its share is capped at the
    demand and the surplus re-flows to the uncapped jobs.  Every split is
    appended to ``history``.

    ``mode`` decides how a shrunken slice reaches a running job's plan:
    ``"boundary"`` (the paper's rule) at its next iteration boundary;
    ``"preempt"`` also mid-iteration, at its next safe point
    (``GlobalController._preempt_victims``).  In either mode a controller
    with ``hold_slices`` also sets the running executor's budget guard to
    the shrunken slice at once, floored at what one of its operators must
    hold at once.
    """

    def __init__(self, capacity_bytes: int, policy: str = "equal",
                 mode: str = "boundary",
                 telemetry: Optional[TelemetryHub] = None):
        if policy not in ARBITER_POLICIES:
            raise KeyError(f"unknown arbiter policy {policy!r}; "
                           f"known: {sorted(ARBITER_POLICIES)}")
        if mode not in ARBITER_MODES:
            raise KeyError(f"unknown arbiter mode {mode!r}; "
                           f"known: {list(ARBITER_MODES)}")
        self.capacity = int(capacity_bytes)
        self.policy = policy
        self.mode = mode
        # the eor-learned policy reads each job's stall share from here
        self.telemetry = telemetry
        self.priorities: Dict[str, float] = {}
        self.demands: Dict[str, int] = {}       # peak demand, bytes
        # priors (TelemetrySummary-shaped: stall_share, peak_bytes) stand
        # in for live measurements of jobs that have none yet
        self.priors: Dict[str, Any] = {}
        # jobs whose demand a live measured peak has updated: from then on
        # a prior no longer overrides the peak policy
        self.live_peak_seen: Dict[str, bool] = {}
        self.history: List[Dict[str, int]] = []
        self.last_assignment: Dict[str, int] = {}

    # -- victim selection ----------------------------------------------
    def victims(self, new_assignment: Dict[str, int],
                prev_assignment: Dict[str, int],
                usage: Dict[str, int]) -> List[str]:
        """Jobs whose slice shrank and whose expected footprint (the
        controller passes max(live bytes, measured peak)) exceeds the new
        slice, largest over-share first."""
        out = [j for j, b in new_assignment.items()
               if j in prev_assignment and b < prev_assignment[j]
               and usage.get(j, 0) > b]
        out.sort(key=lambda j: new_assignment[j] - usage.get(j, 0))
        return out

    # -- registry ------------------------------------------------------
    def register(self, job_id: str, priority: float = 1.0,
                 demand_bytes: int = 0) -> None:
        self.priorities[job_id] = priority
        self.demands[job_id] = int(demand_bytes)

    def update_demand(self, job_id: str, demand_bytes: int) -> None:
        """Fold in a measured peak (a monotone max: demand never shrinks
        within a job's lifetime)."""
        if job_id in self.demands:
            self.demands[job_id] = max(self.demands[job_id],
                                       int(demand_bytes))
            self.live_peak_seen[job_id] = True

    def set_prior(self, job_id: str, prior) -> None:
        """Attach a prior (``stall_share``, ``peak_bytes``) for a job that
        has no live samples yet."""
        if prior is not None:
            self.priors[job_id] = prior

    def unregister(self, job_id: str) -> None:
        self.priorities.pop(job_id, None)
        self.demands.pop(job_id, None)
        self.priors.pop(job_id, None)
        self.live_peak_seen.pop(job_id, None)

    # -- the split -----------------------------------------------------
    def split(self, live: Sequence[str]) -> Dict[str, int]:
        live = [j for j in live if j in self.priorities]
        if not live:
            self.last_assignment = {}
            return {}
        weights = ARBITER_POLICIES[self.policy](self, live)
        assignment: Dict[str, int] = {}
        remaining = self.capacity
        pool = sorted(live)
        # water-fill: give each job its weighted share of what is left;
        # jobs capped by demand leave the pool and their surplus re-flows
        while pool and remaining > 0:
            total_w = sum(weights[j] for j in pool)
            capped = []
            for j in pool:
                share = int(remaining * weights[j] / total_w)
                demand = self.demands.get(j, 0)
                if demand and demand < share:
                    assignment[j] = demand
                    capped.append(j)
            if not capped:
                for j in pool:
                    assignment[j] = int(remaining * weights[j] / total_w)
                break
            remaining -= sum(assignment[j] for j in capped)
            pool = [j for j in pool if j not in capped]
        for j in live:
            assignment.setdefault(j, 0)
        self.last_assignment = dict(assignment)
        self.history.append(dict(assignment))
        return assignment


class GlobalController:
    def __init__(self, profile: Optional[MachineProfile] = None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 cost_model: Optional[CostModel] = None,
                 device_capacity: Optional[int] = None,
                 async_swap: bool = True,
                 pipeline_name: Optional[str] = None,
                 arbiter: Optional[BudgetArbiter] = None,
                 arbiter_policy: Optional[str] = None,
                 arbiter_mode: Optional[str] = None,
                 telemetry: Optional[TelemetryHub] = None,
                 safe_point_source: str = "measured",
                 experience: Optional[ExperienceStore] = None,
                 experience_dir: Optional[str] = None,
                 events: Optional[EventLog] = None, drift=None,
                 device=None, hold_slices: bool = False):
        # every job's tensors live here; a missing card raises
        self.device = resolve_device(device)
        # give each train job's executor its slice as its budget (the
        # executor's budget guard); off, executors run their plans as
        # planned, as the reference's do
        self.hold_slices = hold_slices
        self.profile = profile or MachineProfile()
        # failure paths that must never take a job down (experience
        # flushes, survivor and preempt replans) emit WARN events here
        # beside their lists
        self.events = events if events is not None else EventLog()
        # optional sim-vs-measured drift monitor: submit pins the predicted
        # peak, _on_job_exit feeds it the measured one
        self.drift = drift
        # one measured-telemetry hub per device: every executor produces
        # into it; safe points, drift replans and the eor-learned policy
        # read from it
        self.telemetry = telemetry or TelemetryHub(clock="real")
        # the experience plane: an attached store warm-boots the cost
        # model's calibration, the pipeline's plan cache, the planner's DMA
        # bandwidth and the arbiter's priors; distilled experience flushes
        # back on job exit
        if experience is None and experience_dir is not None:
            experience = ExperienceStore(
                experience_dir, device_id=device_identity(self.profile))
        self.experience = experience
        # (job_id, error) of experience lookups and flushes that failed
        self.experience_failures: List[tuple] = []
        # how `_preempt_victims` finds splice points: "measured" from the
        # hub's residency records (modelled until enough samples), or
        # "modeled" from the plan's ledger model
        self.safe_point_source = safe_point_source
        pipeline = None
        if pipeline_name is not None:
            from .passes import build_pipeline
            scheduler_config = scheduler_config or SchedulerConfig()
            pipeline = build_pipeline(pipeline_name, profile=self.profile,
                                      config=scheduler_config)
        self.scheduler = MemoryScheduler(self.profile, scheduler_config,
                                         pipeline=pipeline,
                                         experience=self.experience)
        if self.scheduler.pipeline.telemetry is None:
            self.scheduler.pipeline.telemetry = self.telemetry
        # with a store attached, capture-time latency estimates start from
        # the calibration a prior run persisted (an explicit model wins)
        self.cost_model = cost_model or CostModel(experience=self.experience)
        # one engine ledger and DMA channel shared by every job
        self.engine = MemoryEngine(self.profile,
                                   capacity_bytes=device_capacity,
                                   telemetry=self.telemetry)
        self.accountant: DeviceLedger = self.engine.ledger
        self.channel: DmaChannel = self.engine.channel
        # the channel's copy stream on a card, for every job's transfers
        # (made with the first train job)
        self.copy_stream: Optional["torch.cuda.Stream"] = None
        # the device-wide budget the arbiter splits: explicit capacity,
        # else the scheduler's budget, else the device size
        cap = device_capacity
        if cap is None:
            cap = (self.scheduler.config.memory_budget_bytes
                   or self.profile.device_memory_bytes)
        mode = arbiter_mode or self.scheduler.config.arbiter_mode
        self.arbiter = arbiter or (
            BudgetArbiter(cap, policy=arbiter_policy, mode=mode,
                          telemetry=self.telemetry)
            if arbiter_policy is not None else None)
        if self.arbiter is not None and self.arbiter.telemetry is None:
            self.arbiter.telemetry = self.telemetry
        self.async_swap = async_swap
        self.jobs: Dict[str, JobHandle] = {}
        self._lock = threading.Lock()
        self._replan_count = 0
        # seconds of each replan (split, plan, preemption), under the lock
        self.replan_seconds: List[float] = []
        self._preempt_count = 0
        # replans that failed while redistributing a departed job's budget
        # (survivors keep their plans): (departed_job_id, error)
        self.replan_failures: List[tuple] = []
        # remainder replans that failed while preempting a victim (it keeps
        # its plan to the boundary): (job_id, error)
        self.preempt_failures: List[tuple] = []

    # ------------------------------------------------------------------
    def _check_device(self, job_id: str, devices) -> None:
        """A payload must live on the controller's device: a job is never
        moved to another device, and never falls back to one."""
        for d in devices:
            if d.type != self.device.type:
                raise ValueError(f"job {job_id!r}: payload on {d}, the "
                                 f"controller runs on {self.device}")

    def capture_spec(self, spec) -> CapturedJob:
        """Admission hook #1: resolve a ``JobSpec`` and capture its graph
        (``service.workloads``: an in-process ``spec.payload`` wins, else
        the workload factory named by ``spec.workload``, given the
        controller's device where it takes one).  The capture is reusable:
        capture once, predict the peak, then ``submit`` it.

        Serve specs (``kind="serve"``) have no graph: they capture to a
        synthetic access sequence whose tensors are the per-slot KV
        footprints, so ``predict_peak`` and the arbiter see a serving job
        through the same lens as a training one."""
        if getattr(spec, "kind", "train") == "serve":
            return self._capture_serve_spec(spec)
        from ..service.workloads import resolve_workload
        step_fn, params, opt_state, batch = resolve_workload(
            spec, device=self.device)
        self._check_device(spec.job_id, [
            t.device for t in pytree.tree_leaves((params, opt_state, batch))
            if isinstance(t, torch.Tensor)])
        # reflect current device contention into cold-start predictions
        self.cost_model.utilization = min(
            0.9, 0.3 * sum(1 for j in self.jobs.values() if not j.done))
        seq, gm = capture_train_step(
            step_fn, params, opt_state, batch, job_id=spec.job_id,
            cost_model=self.cost_model)
        fp = spec.fingerprint
        if self.experience is not None:
            try:
                fp = self.experience.fingerprint(seq)
            except Exception as e:  # noqa: BLE001 - cold boot instead
                self.experience_failures.append((spec.job_id, e))
                self.events.warn("experience",
                                 "fingerprint computation failed; "
                                 "job cold-boots",
                                 job_id=spec.job_id, error=repr(e))
        return CapturedJob(seq=seq, graph_module=gm,
                           args=(params, opt_state, batch), fingerprint=fp)

    # ------------------------------------------------------------------
    def _capture_serve_spec(self, spec) -> CapturedJob:
        """Resolve a serve spec to ``(serving_engine, requests)`` and build
        the synthetic sequence standing in for its graph: one decode-turn
        operator touching a full-cache tensor per batch slot.  Its no-free
        peak is the all-slots-resident KV bound."""
        from ..service.workloads import resolve_serve_workload
        from .access import Operator, TensorKind, TensorSpec
        engine, requests = resolve_serve_workload(spec,
                                                  device=self.device)
        self._check_device(spec.job_id, [engine.device])
        sp = spec.serve
        per_seq = engine.bytes_per_token * (sp.prompt_len + sp.gen_len)
        tensors = {
            f"kvslot{i}": TensorSpec(
                tid=f"kvslot{i}", size_bytes=per_seq,
                kind=TensorKind.ACTIVATION, job_id=spec.job_id)
            for i in range(sp.max_sequences)}
        ops = [Operator(idx=0, name="decode_turn", inputs=tuple(tensors),
                        outputs=tuple(tensors), latency=1e-3,
                        job_id=spec.job_id)]
        seq = AccessSequence(spec.job_id, ops, tensors, initial_resident=[])
        return CapturedJob(seq=seq, graph_module=None,
                           args=(engine, requests), fingerprint=None)

    # ------------------------------------------------------------------
    def predict_peak(self, seq: AccessSequence,
                     budget_hint_bytes: Optional[int] = None
                     ) -> Tuple[int, str]:
        """Admission hook #2: predicted peak bytes of a captured job and
        its provenance.  A fingerprint the experience store knows returns
        the peak a prior run measured (``"experience"``), else the smallest
        certified peak of its stored plans (``"experience-plan"``); an
        unknown one the analyzer's no-free bound (every tensor held to its
        last use), raised to the caller's hint (``"cost-model"``)."""
        if self.experience is not None:
            try:
                prior = self.experience.predicted_peak(seq)
                if prior is not None:
                    return prior
            except Exception as e:  # noqa: BLE001 - fall through to model
                self.events.warn("experience",
                                 "predicted-peak prior lookup failed; "
                                 "using cost-model bound",
                                 job_id=seq.job_id, error=repr(e))
        bound = int(analyze([seq], free_at_last_use=False).peak_bytes)
        if budget_hint_bytes:
            bound = max(bound, int(budget_hint_bytes))
        return bound, "cost-model"

    # ------------------------------------------------------------------
    def submit(self, spec, captured: Optional[CapturedJob] = None
               ) -> JobHandle:
        """Register and start a job from a ``JobSpec`` on a thread of its
        own.  ``spec.priority`` feeds the priority policy and PriorityPass
        (None: the scheduler config's, else 1.0).  Pass ``captured`` to
        reuse a ``capture_spec`` result."""
        if captured is None:
            captured = self.capture_spec(spec)
        if getattr(spec, "kind", "train") == "serve":
            return self._submit_serve(spec, captured)
        seq = captured.seq
        with self._lock:
            if spec.job_id in self.jobs and not self.jobs[spec.job_id].done:
                raise ValueError(f"job {spec.job_id!r} is already live")
            self.scheduler.register_job(seq, priority=spec.priority)
            eff_priority = self.scheduler.priority_of(spec.job_id)
            handle = JobHandle(job_id=spec.job_id, seq=seq,
                               graph_module=captured.graph_module,
                               args=captured.args,
                               iterations=spec.iterations,
                               priority=eff_priority, spec=spec,
                               fingerprint=captured.fingerprint)
            self.jobs[spec.job_id] = handle
            if self.copy_stream is None and self.device.type == "cuda":
                self.copy_stream = torch.cuda.Stream(self.device)
            if self.arbiter is not None:
                # peak demand: the no-free peak until measurements land
                demand = analyze([seq], free_at_last_use=False).peak_bytes
                self.arbiter.register(spec.job_id, priority=eff_priority,
                                      demand_bytes=demand)
            if self.experience is not None:
                # a prior run's distilled telemetry stands in for the live
                # samples this job has not produced yet
                try:
                    prior = self.experience.prior(seq)
                    if prior is not None and self.arbiter is not None:
                        self.arbiter.set_prior(spec.job_id, prior)
                except Exception as e:  # noqa: BLE001 - cold boot instead
                    self.experience_failures.append((spec.job_id, e))
                    self.events.warn("experience",
                                     "arbiter prior lookup failed; "
                                     "job starts with live samples only",
                                     job_id=spec.job_id, error=repr(e))
            if self.drift is not None:
                # the admission-time prediction, pinned for the comparison
                # at exit
                try:
                    handle.predicted_peak, _src = self.predict_peak(seq)
                except Exception:  # noqa: BLE001 - drift is best-effort
                    handle.predicted_peak = None
            if spec.schedule:
                self._replan()
        t = threading.Thread(target=self._run_job, args=(handle,), daemon=True)
        handle.thread = t
        t.start()
        return handle

    # ------------------------------------------------------------------
    def _submit_serve(self, spec, captured: CapturedJob) -> JobHandle:
        """Register and start a serving job.  It shares the ledger, the
        channel and the arbiter's split with the training jobs, but its
        residency is planned per decode turn by the serving plane's
        ``KvResidencyPass``: the Memory Scheduler never sees it."""
        with self._lock:
            if spec.job_id in self.jobs and not self.jobs[spec.job_id].done:
                raise ValueError(f"job {spec.job_id!r} is already live")
            handle = JobHandle(job_id=spec.job_id, seq=captured.seq,
                               graph_module=None, args=captured.args,
                               iterations=spec.iterations,
                               priority=spec.priority or 1.0, spec=spec)
            self.jobs[spec.job_id] = handle
            if self.arbiter is not None:
                demand = analyze([captured.seq],
                                 free_at_last_use=False).peak_bytes
                self.arbiter.register(spec.job_id,
                                      priority=spec.priority or 1.0,
                                      demand_bytes=demand)
            if spec.schedule:
                self._replan()
        t = threading.Thread(target=self._run_serve_job, args=(handle,),
                             daemon=True)
        handle.thread = t
        t.start()
        return handle

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _job_stream(self, handle: JobHandle):
        """On a card, a compute stream of the job's own for the thread's
        work, ordered after what the submitting thread queued.  The job's
        starting tensors (made on that thread's stream) are marked as used
        on it, so the allocator does not hand their memory out again
        before the job's kernels have read them."""
        if self.device.type != "cuda":
            yield
            return
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        for t in pytree.tree_leaves(handle.args):
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                t.record_stream(stream)
        with torch.cuda.stream(stream):
            yield

    # ------------------------------------------------------------------
    def _run_serve_job(self, handle: JobHandle) -> None:
        """Thread body of a serving job: the ServingEngine serves the
        request trace against OUR ledger and channel, so KV blocks and
        training tensors contend for the same bytes and the same link."""
        try:
            engine, requests = handle.args
            sp = handle.spec.serve
            with self._job_stream(handle):
                report, tokens = engine.serve(
                    requests, budget_bytes=handle.budget_bytes,
                    schedule=handle.spec.schedule,
                    block_tokens=sp.block_tokens, engine=self.engine,
                    job_id=handle.job_id, batch_transfers=True)
            handle.stats.append(report)
            handle.step_times.append(report.total_time)
            handle.peak_bytes = max(handle.peak_bytes, report.peak_bytes)
            handle.outputs = tokens
        except BaseException as e:  # noqa: BLE001 - surfaced via wait()
            handle.error = e
            handle.error_tb = traceback.format_exc()
        finally:
            self._on_job_exit(handle)

    # ------------------------------------------------------------------
    def launch(self, step_fn: Callable, params, opt_state, batch,
               job_id: str, iterations: int = 3,
               schedule: bool = True,
               priority: Optional[float] = None) -> JobHandle:
        """Deprecated shim over :meth:`submit`: builds a ``JobSpec`` with
        an in-process payload and submits it."""
        warnings.warn(
            "GlobalController.launch(step_fn, ...) is deprecated; build a "
            "repro_torch.service.JobSpec and call "
            "GlobalController.submit(spec)",
            DeprecationWarning, stacklevel=2)
        from ..service.jobspec import JobSpec
        spec = JobSpec(job_id=job_id, iterations=iterations,
                       schedule=schedule, priority=priority,
                       payload=(step_fn, params, opt_state, batch))
        return self.submit(spec)

    # ------------------------------------------------------------------
    def _replan(self) -> None:
        """Memory Scheduler pass over all live jobs; distribute plans.

        With an arbiter the device budget is re-split first (arrival,
        departure and drift all come through here) and each job plans
        against its slice.  Executors pick the new plan up at their next
        iteration boundary (``_run_job`` reads it under the lock only
        between iterations).  Called under the controller lock."""
        live = [j for j, h in self.jobs.items() if not h.done]
        if not live:
            return
        t0 = _time.perf_counter()
        budgets: Optional[Dict[str, int]] = None
        prev_assignment: Dict[str, int] = {}
        if self.arbiter is not None:
            for j in live:
                # fold measured peaks (shared-ledger accounting) into demand
                measured = self.accountant.job_peak(j)
                if measured:
                    self.arbiter.update_demand(j, measured)
            prev_assignment = dict(self.arbiter.last_assignment)
            budgets = self.arbiter.split(live)
        # serve jobs take part in the split but not in graph planning
        planned = [j for j in live if not _is_serve(self.jobs[j])]
        if planned:
            plan_budgets = None if budgets is None else {
                j: budgets[j] for j in planned if j in budgets}
            result = self.scheduler.schedule(planned, budgets=plan_budgets)
            for j in planned:
                h = self.jobs[j]
                h.plan = result.plans[j]
                h.plan_version += 1
        for j in live:
            if budgets is not None:
                h = self.jobs[j]
                h.ledger_view = self.accountant.view(j, budgets.get(j))
                if (self.hold_slices and h.executor is not None
                        and not _is_serve(h)):
                    # a held slice follows the split into the iteration
                    # that is running, not only into the next one, but
                    # never below what one of its operators must hold
                    h.executor.budget_bytes = max(
                        h.budget_bytes, h.executor.operator_floor())
        self._replan_count += 1
        if (self.arbiter is not None and self.arbiter.mode == "preempt"
                and budgets is not None):
            self._preempt_victims(budgets, prev_assignment)
        self.replan_seconds.append(_time.perf_counter() - t0)

    # ------------------------------------------------------------------
    def _preempt_victims(self, budgets: Dict[str, int],
                         prev_assignment: Dict[str, int]) -> None:
        """Preemptive arbitration: an arrival just shrank some live jobs'
        slices.  For each victim build a remainder plan (eager swap-outs
        from its next safe point, ``MemoryScheduler.replan_from``) and
        request it from the running executor, which splices it in at a
        safe point.  Every future safe point is eligible: if the executor
        has passed the one the plan was built from, the events triggered
        in between never fire (later ones still apply, and the boundary
        plan completes the shrink).  Called under the controller lock."""
        # expected footprint under the running plan: live bytes now, or
        # the measured peak so far
        usage = {j: max(self.accountant.job_bytes(j),
                        self.accountant.job_peak(j)) for j in budgets}
        for j in self.arbiter.victims(budgets, prev_assignment, usage):
            h = self.jobs.get(j)
            ex = h.executor if h is not None else None
            if ex is None:
                continue            # between iterations: boundary covers it
            running = ex.plan
            safe = find_safe_points(h.seq, running,
                                    source=self.safe_point_source,
                                    telemetry=self.telemetry)
            cur = ex.current_op_index
            future = [sp.op_idx for sp in safe if sp.op_idx > cur]
            if not future:
                continue            # iteration nearly over: boundary covers it
            try:
                res = self.scheduler.replan_from(
                    j, running if running is not None
                    else SchedulingPlan(job_id=j),
                    future[0], budgets[j])
            except Exception as e:  # noqa: BLE001 - victim keeps its plan
                self.preempt_failures.append((j, e))
                self.events.warn("preempt",
                                 "incremental preempt replan failed; "
                                 "victim keeps its plan to the boundary",
                                 job_id=j, error=repr(e))
                continue
            prior_n = len(running.events) if running is not None else 0
            if len(res.plans[j].events) == prior_n:
                continue            # remainder already fits: no-op splice
            ex.request_plan(res.plans[j], future)
            h.preemptions.append((h.plan_version, future[0]))
            self._preempt_count += 1

    # ------------------------------------------------------------------
    def _run_job(self, handle: JobHandle) -> None:
        """Thread body of a train job: its iterations, each on a fresh
        executor of the current plan.  The state is donated to the
        executor (its memory goes where the ledger says) and rebuilt from
        the outputs (``torch.utils._pytree``); storages parked on the host
        at an iteration's end enter the next iteration as host-resident
        inputs, with their host copies (compressed ones stay compressed).
        Nothing here keeps a reference to a donated state: the caller's
        ``CapturedJob`` and an in-process ``spec.payload`` do, so a caller
        that wants the state's memory to follow the plan submits a
        registered workload and drops its capture."""
        try:
            p_spec = pytree.tree_structure(handle.args[0])
            o_spec = pytree.tree_structure(handle.args[1])
            n_p, n_o = p_spec.num_leaves, o_spec.num_leaves
            batch = handle.args[2]
            parked: Dict[str, Any] = {}
            with self._job_stream(handle):
                for it in range(handle.iterations):
                    with self._lock:
                        plan = handle.plan
                        budget = (handle.budget_bytes if self.hold_slices
                                  else None)
                    ex = FxExecutor(
                        handle.graph_module, handle.seq, plan,
                        accountant=self.accountant, channel=self.channel,
                        async_swap=self.async_swap, measure_latency=True,
                        telemetry=self.telemetry,
                        host_resident_inputs=set(parked),
                        copy_stream=self.copy_stream, budget_bytes=budget)
                    ex.host.update(parked)
                    ex.ctx.host_compressed |= {
                        st for st, rec in parked.items() if rec.compressed}
                    with self._lock:
                        # a split made while the executor was built; later
                        # ones reach it from _replan
                        if self.hold_slices:
                            ex.budget_bytes = handle.budget_bytes
                        handle.executor = ex
                    state = list(handle.args)
                    handle.args = None
                    t0 = _time.perf_counter()
                    outs = ex.run_donated(state)
                    handle.step_times.append(_time.perf_counter() - t0)
                    handle.stats.append(ex.stats)
                    handle.peak_bytes = max(handle.peak_bytes,
                                            ex.stats.peak_bytes)
                    # feed params and opt-state back (outputs 0, 1 by
                    # convention)
                    handle.args = (
                        pytree.tree_unflatten(outs[:n_p], p_spec),
                        pytree.tree_unflatten(outs[n_p:n_p + n_o], o_spec),
                        batch)
                    handle.outputs = outs[n_p + n_o:]
                    parked = {st: ex.host[st]
                              for st in ex.ending_host_storages()}
                    del outs
                    # measured-telemetry feedback (paper step 4): fold the
                    # hub's samples into the job's sequence, replan on
                    # drift.  After the last iteration a new plan would
                    # only be stored: a job whose plan kept to its slice
                    # keeps that plan, and the timeline it was built on,
                    # for the experience store, beside the peak it ran at
                    if (it + 1 < handle.iterations
                            or not _within_budget(plan)) \
                            and self.report_telemetry(handle.job_id):
                        with self._lock:
                            self._replan()
                    ex.close()
        except BaseException as e:  # noqa: BLE001 - surfaced via wait()
            handle.error = e
            handle.error_tb = traceback.format_exc()
        finally:
            # departure bookkeeping runs for clean finishes and crashes: a
            # failure while replanning the survivors must not blame this job
            self._on_job_exit(handle)

    # ------------------------------------------------------------------
    def _on_job_exit(self, handle: JobHandle) -> None:
        """Departure bookkeeping: flush a train job's distilled run into
        the experience store and feed the drift monitor (both while the hub
        still holds the job's records), then deregister from the scheduler
        and the arbiter and redistribute the departed job's slice.  A job
        that held no bytes of the split reclaims nothing, so its departure
        replans nothing."""
        handle.done = True
        handle.executor = None
        is_serve = _is_serve(handle)
        with self._lock:
            if self.experience is not None and not is_serve:
                self._flush_experience(handle)
            if self.drift is not None and not is_serve \
                    and handle.predicted_peak:
                self._observe_drift(handle)
            if not is_serve:
                self.scheduler.remove_job(handle.job_id)
            if self.arbiter is not None:
                reclaimed = self.arbiter.last_assignment.get(
                    handle.job_id, 0)
                self.arbiter.unregister(handle.job_id)
                if reclaimed == 0:
                    return
                try:
                    self._replan()
                except Exception as e:  # noqa: BLE001
                    # survivors keep their current (still valid) plans
                    self.replan_failures.append((handle.job_id, e))
                    self.events.warn("replan",
                                     "survivor replan failed after job "
                                     "departure; current plans kept",
                                     job_id=handle.job_id, error=repr(e))

    # ------------------------------------------------------------------
    def _flush_experience(self, handle: JobHandle) -> None:
        """Record and flush a finished job's distilled experience: its
        telemetry summary, the recalibrated calibration and its final plan
        (the plan its last iteration ran, unless that plan certified over
        its slice and a drift replan followed).  A failure is recorded,
        never raised.  Called under the lock."""
        try:
            self.cost_model.recalibrate(self.telemetry, report=False)
            fp = handle.fingerprint \
                or self.experience.fingerprint(handle.seq)
            self.experience.record_job(
                fp, seq=handle.seq, hub=self.telemetry,
                job_id=handle.job_id, plan=handle.plan,
                pipeline=self.scheduler.pipeline.name,
                peak_bytes=max(handle.peak_bytes,
                               self.accountant.job_peak(handle.job_id)),
                calib=self.cost_model.calib,
                calib_samples=self.telemetry.total_op_samples())
            self.experience.flush()
        except Exception as e:  # noqa: BLE001
            self.experience_failures.append((handle.job_id, e))
            self.events.warn("experience",
                             "experience flush failed on job exit; "
                             "distilled run lost",
                             job_id=handle.job_id, error=repr(e))

    def _observe_drift(self, handle: JobHandle) -> None:
        """Hand the drift monitor the job's admission-time peak prediction
        and its measured peak, and persist the sample at once.  Called
        under the lock."""
        measured = max(handle.peak_bytes,
                       self.accountant.job_peak(handle.job_id))
        if measured <= 0:
            return
        fp = handle.fingerprint or ""
        if not fp and self.experience is not None:
            try:
                fp = self.experience.fingerprint(handle.seq)
            except Exception:  # noqa: BLE001
                fp = ""
        self.drift.observe(fp or handle.job_id,
                           predicted_peak=handle.predicted_peak,
                           measured_peak=measured, job_id=handle.job_id)
        if self.experience is not None:
            try:
                self.experience.flush()
            except Exception as e:  # noqa: BLE001
                self.events.warn("experience",
                                 "drift-history flush failed",
                                 job_id=handle.job_id, error=repr(e))

    # ------------------------------------------------------------------
    def report_latencies(self, job_id: str, measured: List[float]) -> bool:
        with self._lock:
            if job_id not in self.scheduler.jobs:
                return False
            return self.scheduler.update_latencies(job_id, measured)

    def report_telemetry(self, job_id: str) -> bool:
        """Fold the hub's measured latencies into the job's sequence and
        return whether the hub reports drift past the replan threshold.
        The cost model recalibrates from the same new samples, so the next
        capture estimates latencies from measured constants."""
        with self._lock:
            if job_id not in self.scheduler.jobs:
                return False
            self.cost_model.recalibrate(self.telemetry, report=False)
            return self.scheduler.update_latencies_from_hub(
                job_id, self.telemetry)

    def failures(self) -> Dict[str, BaseException]:
        """Failed jobs so far (job_id -> exception)."""
        return {j: h.error for j, h in self.jobs.items()
                if h.error is not None}

    def wait(self, timeout: Optional[float] = None,
             raise_errors: bool = True) -> None:
        """Join every job thread, then raise every job-thread failure at
        once (``JobFailedError``), the first one chained as the cause, even
        when the timeout expires before every thread joins."""
        deadline = None if timeout is None else _time.time() + timeout
        for h in list(self.jobs.values()):
            if h.thread is None:
                continue
            remaining = (None if deadline is None
                         else max(0.0, deadline - _time.time()))
            h.thread.join(remaining)
        failures = self.failures()
        if failures and raise_errors:
            tbs = {j: self.jobs[j].error_tb for j in failures
                   if self.jobs[j].error_tb}
            err = JobFailedError(failures, tbs)
            raise err from next(iter(failures.values()))

    @property
    def global_peak_bytes(self) -> int:
        return self.accountant.peak

    @property
    def replan_count(self) -> int:
        return self._replan_count

    @property
    def preempt_count(self) -> int:
        """Mid-iteration plan hot-swaps requested so far (arbiter mode
        "preempt")."""
        return self._preempt_count
