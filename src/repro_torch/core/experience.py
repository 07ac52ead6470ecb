"""The experience plane: a persistent cross-run store for warm-boot
scheduling, so a recurring job starts from what its last run measured.

A copy of the JAX package's ``core/experience.py`` over the port's
``access``, ``plan``, ``peak_analysis`` and ``cost_model``.  TENSILE's
answer to the **cold-start problem** is to plan a job *before* it has run,
from experience gathered on prior runs of the same (recurring) workload.
Everything a run measures dies with the process: the ``TelemetryHub``,
the online recalibrated ``DeviceCalibration``, and the converged plans.
This module persists the *distilled* form of all three, keyed by a
structural **job fingerprint**, so the next process starts from
experience instead of probe constants:

  fingerprint(seq)           op kinds + tensor shapes/dtypes/kinds +
                             wiring, hashed -- invariant across processes
                             and parameter VALUES, different across
                             shape/topology changes, salted by the device
                             identity (experience must not cross device
                             classes)
        |
        v
  ExperienceStore            versioned JSON-lines files under a
                             configurable root (``<root>/v1/<fp>.jsonl``),
                             one entry per fingerprint holding
                               * a TelemetrySummary (per-primitive latency
                                 fits, measured DMA bandwidth, stall
                                 share, measured peak),
                               * the recalibrated DeviceCalibration, and
                               * the best known SchedulingPlan per
                                 (budget-bucket, pipeline) with its
                                 achieved peak / EOR,
                             plus one device-level record (calibration +
                             transfer totals) for consumers that exist
                             before any fingerprint does
        |
        v
  warm-boot consumers        CostModel(experience=...) starts from the
                             persisted calibration; SwapPlanner seeds
                             ``measured_bandwidth`` from stored transfer
                             summaries; Pipeline.plan consults the plan
                             cache (re-verified against the CURRENT
                             budget before trust); BudgetArbiter priors
                             stand in for live telemetry on cold jobs;
                             GlobalController flushes distilled
                             experience back on job finish.

Trust rules -- warm boot must never be less safe than cold boot:

  * a cached plan is **rebased** onto the current sequence timeline
    (triggers are op-keyed; deltas scale with the iteration time) and
    **re-verified** through the peak-analysis simulator against the
    current budget; any structural mismatch or a peak above budget falls
    back to cold planning;
  * a corrupt file, an unreadable line, or a schema-version mismatch
    silently degrades to a cold boot -- the store can never crash a run;
  * writers are concurrency-safe: every flush is read-merge-replace with an
    atomic ``os.replace`` and last-writer-wins semantics over monotonic
    sample counts, so multiple controller processes may share one store.

The files are the reference's, record for record: a store either package
wrote reads in the other.  The in-memory planner memo (``JobPassState``)
lives in ``pass_state.py``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import threading
import time as _time
from typing import Dict, Iterator, List, Optional, Tuple

from .access import AccessSequence
from .cost_model import DeviceCalibration
from .pass_state import JobPassState, build_pass_state
from .peak_analysis import analyze
from .plan import EventType, MachineProfile, SchedulingPlan

SCHEMA_VERSION = 1

# a stored bandwidth estimate is trusted only past this many transfers
# (mirrors TelemetryHub.measured_bandwidth's live threshold)
MIN_BANDWIDTH_SAMPLES = 3


# ----------------------------------------------------------------------
# Fingerprints
# ----------------------------------------------------------------------
def sequence_signature(seq: AccessSequence) -> Dict[str, object]:
    """The structural identity of a captured job: operator kinds and their
    tensor wiring, plus every tensor's shape/dtype/kind/aliasing.  No
    latencies (they vary with calibration), no parameter values, no job
    id — two captures of the same step function on the same shapes
    produce the same signature in any process."""
    return {
        "ops": [[op.name, list(op.inputs), list(op.outputs)]
                for op in seq.operators],
        "tensors": {tid: [list(t.shape), t.dtype, t.kind.value, t.updates]
                    for tid, t in sorted(seq.tensors.items())},
        "initial_resident": list(seq.initial_resident),
    }


# fingerprint is an O(n) json dump + sha256 over the whole signature and
# sits on every warm-boot lookup / telemetry flush; the signature is
# structural (no latencies), so one computation per sequence object is
# enough — keyed by the sequence's unique serial
_FP_CACHE: Dict[Tuple[int, str], str] = {}


def fingerprint(seq: AccessSequence, device_id: str = "default") -> str:
    """Structural job fingerprint, salted by the device identity (a store
    is per device class: experience measured on one device must not
    warm-boot a different one) and the store schema version."""
    key = (getattr(seq, "serial", id(seq)), device_id)
    hit = _FP_CACHE.get(key)
    if hit is not None:
        return hit
    sig = {"schema": SCHEMA_VERSION, "device": device_id,
           "job": sequence_signature(seq)}
    blob = json.dumps(sig, sort_keys=True, separators=(",", ":"))
    fp = hashlib.sha256(blob.encode()).hexdigest()
    if len(_FP_CACHE) > 512:
        _FP_CACHE.clear()
    _FP_CACHE[key] = fp
    return fp


def device_identity(profile: MachineProfile) -> str:
    """Coarse device-class identity from the profile's construction-time
    constants (NOT the online-recalibrated values, which drift)."""
    return (f"flops={profile.compute_flops:.3g};bw={profile.mem_bw:.3g};"
            f"link={profile.host_link_bw:.3g};"
            f"mem={profile.device_memory_bytes}")


def budget_bucket(budget_bytes: int) -> int:
    """Geometric budget bucket (~25 % wide): the plan-cache key quantizes
    the budget so near-identical budgets share one best-plan slot; the
    CURRENT budget is always re-verified exactly at lookup."""
    if budget_bytes <= 0:
        return -1
    return int(round(math.log(budget_bytes, 1.25)))


# ----------------------------------------------------------------------
# Stored records
# ----------------------------------------------------------------------
@dataclasses.dataclass
class TelemetrySummary:
    """Distilled TelemetryHub state for one fingerprint: enough to seed
    every live consumer, small enough to persist."""

    samples: int = 0                 # op samples folded in
    iterations: int = 0              # completed instrumented iterations
    # per-primitive latency fit: n / mean flops / mean bytes / mean latency
    per_prim: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    # measured DMA path totals (source bytes, busy seconds, transfers)
    dma: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    stall_share: float = 0.0
    measured_eor: float = 0.0
    peak_bytes: int = 0              # measured per-job peak, bytes
    updated_at: float = 0.0

    def bandwidth(self, compressed: bool = False) -> Optional[float]:
        d = self.dma.get("compressed" if compressed else "full")
        if not d or d.get("n", 0) < MIN_BANDWIDTH_SAMPLES:
            return None
        if d.get("seconds", 0.0) <= 0:
            return None
        return d["bytes"] / d["seconds"]


@dataclasses.dataclass
class CalibrationRecord:
    flops: float
    mem_bw: float
    overhead_s: float
    samples: int = 0
    updated_at: float = 0.0

    def to_calibration(self) -> DeviceCalibration:
        return DeviceCalibration(flops=self.flops, mem_bw=self.mem_bw,
                                 overhead_s=self.overhead_s)


@dataclasses.dataclass
class PlanRecord:
    """Best known plan for one (pipeline, budget-bucket) slot."""

    pipeline: str
    bucket: int
    budget_bytes: int
    peak_bytes: int                  # achieved (certified) peak
    eor: Optional[float]
    samples: int
    iteration_time: float            # timeline the plan was built on
    plan: Dict[str, object]          # SchedulingPlan.to_dict()
    updated_at: float = 0.0

    @property
    def key(self) -> str:
        return f"{self.pipeline}@{self.bucket}"


@dataclasses.dataclass
class DeviceRecord:
    """Device-level experience: the latest recalibrated constants and the
    DMA transfer totals — consumers that exist before any job fingerprint
    does (CostModel construction, SwapPlanner window sizing) read this."""

    calibration: Optional[CalibrationRecord] = None
    transfers: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    updated_at: float = 0.0

    def bandwidth(self, compressed: bool = False) -> Optional[float]:
        d = self.transfers.get("compressed" if compressed else "full")
        if not d or d.get("n", 0) < MIN_BANDWIDTH_SAMPLES:
            return None
        if d.get("seconds", 0.0) <= 0:
            return None
        return d["bytes"] / d["seconds"]


@dataclasses.dataclass
class DriftRecord:
    """One sim-vs-measured drift comparison (observability plane).

    Appended per finished comparison by ``DriftMonitor`` through
    ``ExperienceStore.record_drift``; readers that predate the record
    kind skip it (unknown kinds are ignored by ``_entry_of``), so this
    is an additive schema extension, not a version bump."""

    t: float
    job_id: str
    predicted_peak: int
    measured_peak: int
    peak_drift: float
    eor_drift: Optional[float] = None
    sp_drift: Optional[float] = None


# drift history kept per fingerprint (a bounded time series, not a log)
DRIFT_HISTORY_LIMIT = 64


@dataclasses.dataclass
class ExperienceEntry:
    """Everything persisted for one job fingerprint."""

    fingerprint: str
    telemetry: Optional[TelemetrySummary] = None
    calibration: Optional[CalibrationRecord] = None
    plans: Dict[str, PlanRecord] = dataclasses.field(default_factory=dict)
    drift: List[DriftRecord] = dataclasses.field(default_factory=list)

    @property
    def updated_at(self) -> float:
        stamps = [r.updated_at for r in
                  [self.telemetry, self.calibration, *self.plans.values()]
                  if r is not None]
        return max(stamps, default=0.0)

    @property
    def samples(self) -> int:
        return self.telemetry.samples if self.telemetry else 0


# ----------------------------------------------------------------------
# Merge rules: last-writer-wins over MONOTONIC sample counts
# ----------------------------------------------------------------------
def _merge_telemetry(a: Optional[TelemetrySummary],
                     b: Optional[TelemetrySummary]
                     ) -> Optional[TelemetrySummary]:
    if a is None:
        return b
    if b is None:
        return a
    # the record with more samples wins wholesale (a hub accumulates, so
    # a later flush from the same run always has >= samples; across runs
    # the richer history wins); measured peaks stay monotone max
    win, lose = (a, b) if (a.samples, a.updated_at) >= (b.samples,
                                                        b.updated_at) else (b, a)
    win = dataclasses.replace(
        win, per_prim={p: dict(d) for p, d in win.per_prim.items()},
        dma={p: dict(d) for p, d in win.dma.items()})
    win.peak_bytes = max(win.peak_bytes, lose.peak_bytes)
    return win


def _merge_calibration(a: Optional[CalibrationRecord],
                       b: Optional[CalibrationRecord]
                       ) -> Optional[CalibrationRecord]:
    if a is None:
        return b
    if b is None:
        return a
    return a if (a.samples, a.updated_at) >= (b.samples, b.updated_at) else b


def _better_plan(a: Optional[PlanRecord], b: PlanRecord) -> PlanRecord:
    """Lower certified peak wins; ties go to the record with more samples
    behind it, then the newer one."""
    if a is None:
        return b
    ka = (a.peak_bytes, -a.samples, -a.updated_at)
    kb = (b.peak_bytes, -b.samples, -b.updated_at)
    return a if ka <= kb else b


def _merge_entries(a: Optional[ExperienceEntry],
                   b: ExperienceEntry) -> ExperienceEntry:
    if a is None:
        return b
    out = ExperienceEntry(fingerprint=a.fingerprint or b.fingerprint)
    out.telemetry = _merge_telemetry(a.telemetry, b.telemetry)
    out.calibration = _merge_calibration(a.calibration, b.calibration)
    out.plans = dict(a.plans)
    for key, rec in b.plans.items():
        out.plans[key] = _better_plan(out.plans.get(key), rec)
    # drift history: union by (t, job_id), time-ordered, bounded
    seen = set()
    drift: List[DriftRecord] = []
    for rec in sorted(a.drift + b.drift, key=lambda r: (r.t, r.job_id)):
        key = (rec.t, rec.job_id)
        if key not in seen:
            seen.add(key)
            drift.append(rec)
    out.drift = drift[-DRIFT_HISTORY_LIMIT:]
    return out


def _merge_device(a: Optional[DeviceRecord],
                  b: Optional[DeviceRecord]) -> Optional[DeviceRecord]:
    if a is None:
        return b
    if b is None:
        return a
    out = DeviceRecord()
    out.calibration = _merge_calibration(a.calibration, b.calibration)
    # transfer totals: the record with more transfers behind it wins (the
    # totals are cumulative within a run, not across runs — summing two
    # flushes of the same hub would double-count)
    for path in set(a.transfers) | set(b.transfers):
        da, db = a.transfers.get(path), b.transfers.get(path)
        if da is None or (db is not None and db.get("n", 0) >= da.get("n", 0)):
            out.transfers[path] = dict(db)
        else:
            out.transfers[path] = dict(da)
    out.updated_at = max(a.updated_at, b.updated_at)
    return out


# ----------------------------------------------------------------------
# Distillation from a live TelemetryHub
# ----------------------------------------------------------------------
def distill_telemetry(hub, job_id: str,
                      peak_bytes: int = 0) -> TelemetrySummary:
    """Fold one job's hub records into the persistent summary shape.
    Transfer totals are filtered to THIS job — a multi-job hub must not
    leak other jobs' transfers into a per-workload record (the hub-wide
    totals live in the device-level record instead)."""
    per_prim = hub.op_summary(job_id)
    samples = sum(int(d.get("n", 0)) for d in per_prim.values())
    dma: Dict[str, Dict[str, float]] = {}
    for path, compressed in (("full", False), ("compressed", True)):
        n, nbytes, seconds = hub.transfer_totals(compressed=compressed,
                                                 job_id=job_id)
        if n:
            dma[path] = {"n": float(n), "bytes": float(nbytes),
                         "seconds": float(seconds)}
    measured_peak = max([peak_bytes]
                        + [b for _t, b in hub.residency_timeline(job_id)])
    return TelemetrySummary(
        samples=samples, iterations=hub.iterations(job_id),
        per_prim=per_prim, dma=dma,
        stall_share=hub.stall_share(job_id),
        measured_eor=hub.measured_eor(job_id),
        peak_bytes=int(measured_peak), updated_at=_time.time())


# ----------------------------------------------------------------------
# (De)serialization — one typed JSON line per record
# ----------------------------------------------------------------------
def _records_of(entry: ExperienceEntry) -> List[Dict[str, object]]:
    recs: List[Dict[str, object]] = [
        {"kind": "header", "schema": SCHEMA_VERSION,
         "fingerprint": entry.fingerprint}]
    if entry.telemetry is not None:
        recs.append({"kind": "telemetry",
                     **dataclasses.asdict(entry.telemetry)})
    if entry.calibration is not None:
        recs.append({"kind": "calibration",
                     **dataclasses.asdict(entry.calibration)})
    for rec in entry.plans.values():
        recs.append({"kind": "plan", **dataclasses.asdict(rec)})
    for rec in entry.drift[-DRIFT_HISTORY_LIMIT:]:
        recs.append({"kind": "drift", **dataclasses.asdict(rec)})
    return recs


def _entry_of(fp: str,
              records: List[Dict[str, object]]) -> ExperienceEntry:
    entry = ExperienceEntry(fingerprint=fp)
    for rec in records:
        kind = rec.get("kind")
        body = {k: v for k, v in rec.items() if k != "kind"}
        try:
            if kind == "telemetry":
                entry.telemetry = _merge_telemetry(
                    entry.telemetry, TelemetrySummary(**body))
            elif kind == "calibration":
                entry.calibration = _merge_calibration(
                    entry.calibration, CalibrationRecord(**body))
            elif kind == "plan":
                pr = PlanRecord(**body)
                entry.plans[pr.key] = _better_plan(entry.plans.get(pr.key),
                                                   pr)
            elif kind == "drift":
                entry.drift.append(DriftRecord(**body))
        except TypeError:
            continue        # unknown field layout: skip the record
    entry.drift.sort(key=lambda r: (r.t, r.job_id))
    del entry.drift[:-DRIFT_HISTORY_LIMIT]
    return entry


# ----------------------------------------------------------------------
# The store
# ----------------------------------------------------------------------
class ExperienceStore:
    """Versioned on-disk experience store.

    Layout: ``<root>/v<SCHEMA_VERSION>/<fingerprint>.jsonl`` — one
    JSON-lines file per fingerprint (header line + one line per typed
    record) — plus one ``device-<id>.jsonl`` for device-level experience.
    Reads are tolerant (corrupt lines skipped, corrupt/mismatched files
    read as absent); writes are read-merge-replace with ``os.replace``
    atomicity, so concurrent writers interleave safely and merge rules
    keep sample counts monotone.
    """

    SCHEMA = SCHEMA_VERSION

    def __init__(self, root: str, device_id: str = "default"):
        self.root = os.path.abspath(os.path.expanduser(str(root)))
        self.device_id = device_id
        self.dir = os.path.join(self.root, f"v{self.SCHEMA}")
        self._lock = threading.Lock()
        self._pending: Dict[str, ExperienceEntry] = {}
        self._pending_device: Optional[DeviceRecord] = None
        self._tmp_serial = 0
        # in-memory (never persisted) per-fingerprint planner memo
        self._pass_state: Dict[str, JobPassState] = {}

    # -- identity ------------------------------------------------------
    def fingerprint(self, seq: AccessSequence) -> str:
        return fingerprint(seq, device_id=self.device_id)

    def pass_state(self, seq: AccessSequence) -> JobPassState:
        """The in-memory ``JobPassState`` memo for this job — planners
        constructed with this store fetch their structural inputs here
        instead of re-deriving them (identical values either way; the
        memo only changes speed, not decisions)."""
        fp = self.fingerprint(seq)
        with self._lock:
            ps = self._pass_state.get(fp)
            if ps is None:
                if len(self._pass_state) > 256:
                    self._pass_state.clear()
                ps = self._pass_state[fp] = build_pass_state(seq, fp)
            return ps

    def _path(self, fp: str) -> str:
        return os.path.join(self.dir, f"{fp}.jsonl")

    def _device_path(self) -> str:
        tag = hashlib.sha256(self.device_id.encode()).hexdigest()[:12]
        return os.path.join(self.dir, f"device-{tag}.jsonl")

    # -- tolerant reads ------------------------------------------------
    def _read_records(self, path: str) -> Optional[List[Dict[str, object]]]:
        """All parseable records of one file, or None when the file is
        missing, unreadable, or its header names a different schema —
        warm boot silently degrades to cold, never crashes."""
        try:
            with open(path, "r", encoding="utf-8") as f:
                lines = f.read().splitlines()
        except OSError:
            return None
        records: List[Dict[str, object]] = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except (ValueError, TypeError):
                continue
            if not isinstance(rec, dict):
                continue
            records.append(rec)
        if not records:
            return None
        header = records[0]
        if header.get("kind") != "header" \
                or header.get("schema") != self.SCHEMA:
            return None
        return records[1:]

    def get(self, fp: str) -> Optional[ExperienceEntry]:
        recs = self._read_records(self._path(fp))
        if recs is None:
            return None
        entry = _entry_of(fp, recs)
        if entry.telemetry is None and entry.calibration is None \
                and not entry.plans and not entry.drift:
            return None
        return entry

    def device_record(self) -> Optional[DeviceRecord]:
        recs = self._read_records(self._device_path())
        if recs is None:
            return None
        dev = DeviceRecord()
        for rec in recs:
            body = {k: v for k, v in rec.items() if k != "kind"}
            try:
                if rec.get("kind") == "calibration":
                    dev.calibration = _merge_calibration(
                        dev.calibration, CalibrationRecord(**body))
                elif rec.get("kind") == "transfers":
                    dev = _merge_device(dev, DeviceRecord(
                        transfers=body.get("transfers", {}),
                        updated_at=body.get("updated_at", 0.0)))
            except TypeError:
                continue
        if dev.calibration is None and not dev.transfers:
            return None
        return dev

    def fingerprints(self) -> List[str]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return sorted(n[:-6] for n in names
                      if n.endswith(".jsonl") and not n.startswith("device-"))

    def entries(self) -> Iterator[Tuple[str, ExperienceEntry]]:
        for fp in self.fingerprints():
            entry = self.get(fp)
            if entry is not None:
                yield fp, entry

    # -- warm-boot queries ---------------------------------------------
    def device_calibration(self) -> Optional[DeviceCalibration]:
        """The persisted recalibrated constants — ``CostModel`` starts
        from these instead of probe defaults when samples exist."""
        dev = self.device_record()
        if dev is None or dev.calibration is None \
                or dev.calibration.samples <= 0:
            return None
        return dev.calibration.to_calibration()

    def bandwidth(self, compressed: bool = False) -> Optional[float]:
        """Stored effective DMA bandwidth (source bytes/s) of the given
        path — SwapPlanner's window sizing falls back to this between a
        cold start and the first live transfer samples."""
        dev = self.device_record()
        if dev is not None:
            bw = dev.bandwidth(compressed=compressed)
            if bw:
                return bw
        return None

    def lookup_plan(self, seq: AccessSequence, pipeline: str,
                    budget_bytes: int,
                    profile: Optional[MachineProfile] = None
                    ) -> Optional[SchedulingPlan]:
        """Best stored plan for this job under this pipeline that the
        CURRENT budget admits: candidates (best certified peak first) are
        rebased onto the current timeline and re-verified through peak
        analysis; the first one whose verified peak fits the budget is
        returned (with a ``warm-boot`` provenance record).  None — and a
        cold plan — on any mismatch.  ``profile`` is the pipeline's, taken
        as the reference takes it; the rebase keeps the stored transfer
        durations (``_rebase_plan``), so nothing here reads it."""
        fp = self.fingerprint(seq)
        entry = self.get(fp)
        if entry is None or not entry.plans:
            return None
        cands = sorted((r for r in entry.plans.values()
                        if r.pipeline == pipeline),
                       key=lambda r: (r.peak_bytes, -r.samples))
        for rec in cands:
            plan = _rebase_plan(rec, seq)
            if plan is None:
                continue
            try:
                rep = analyze([seq], plans={seq.job_id: plan})
            except Exception:   # noqa: BLE001 - malformed plan: fall back
                continue
            if rep.peak_bytes > budget_bytes:
                continue        # the budget shrank below what this plan
                # certifies: reject, plan cold
            plan.planned_peak_bytes = rep.peak_bytes
            plan.budget_bytes = budget_bytes
            plan.provenance.append({
                "action": "warm-boot", "fingerprint": fp,
                "pipeline": pipeline, "bucket": rec.bucket,
                "stored_budget_bytes": rec.budget_bytes,
                "budget_bytes": budget_bytes,
                "verified_peak_bytes": rep.peak_bytes})
            return plan
        return None

    def prior(self, seq: AccessSequence) -> Optional[TelemetrySummary]:
        """Stored telemetry summary for a job that has not produced live
        samples yet — the BudgetArbiter's eor-learned / peak policies
        read stall share and measured peak from here on cold starts."""
        entry = self.get(self.fingerprint(seq))
        return entry.telemetry if entry is not None else None

    def predicted_peak(self, seq: AccessSequence
                       ) -> Optional[Tuple[int, str]]:
        """Peak-prediction query for admission control: the best stored
        estimate of this job's peak bytes, with its provenance.

        Preference order: the *measured* peak a prior run's telemetry
        distilled (``"experience"``), else the smallest *certified* peak
        among stored verified plans (``"experience-plan"``).  Returns None
        for an unknown fingerprint — admission then falls back to the cost
        model's conservative bound (``GlobalController.predict_peak``)."""
        entry = self.get(self.fingerprint(seq))
        if entry is None:
            return None
        ts = entry.telemetry
        if ts is not None and ts.peak_bytes > 0:
            return int(ts.peak_bytes), "experience"
        certified = [r.peak_bytes for r in entry.plans.values()
                     if r.peak_bytes > 0]
        if certified:
            return int(min(certified)), "experience-plan"
        return None

    # -- recording (in-memory until flush) -----------------------------
    def record_job(self, fp: str, *, seq: AccessSequence, hub, job_id: str,
                   plan: Optional[SchedulingPlan] = None,
                   pipeline: Optional[str] = None,
                   peak_bytes: int = 0,
                   calib: Optional[DeviceCalibration] = None,
                   calib_samples: int = 0,
                   eor: Optional[float] = None) -> None:
        """Distill one finished job's experience: telemetry summary, the
        recalibrated calibration, and (when a plan ran) the plan-cache
        candidate.  Nothing touches disk until ``flush()``."""
        ts = distill_telemetry(hub, job_id, peak_bytes=peak_bytes)
        now = _time.time()
        with self._lock:
            ent = self._pending.setdefault(fp, ExperienceEntry(fp))
            ent.telemetry = _merge_telemetry(ent.telemetry, ts)
            if calib is not None:
                ent.calibration = _merge_calibration(
                    ent.calibration,
                    CalibrationRecord(flops=calib.flops, mem_bw=calib.mem_bw,
                                      overhead_s=calib.overhead_s,
                                      samples=calib_samples, updated_at=now))
            if plan is not None and pipeline \
                    and (plan.events or plan.release_after_op):
                budget = int(plan.budget_bytes or 0)
                rec = PlanRecord(
                    pipeline=pipeline, bucket=budget_bucket(budget),
                    budget_bytes=budget,
                    peak_bytes=int(plan.planned_peak_bytes
                                   or peak_bytes or 0),
                    eor=(eor if eor is not None
                         else ts.measured_eor or None),
                    samples=ts.samples,
                    iteration_time=float(seq.iteration_time),
                    plan=plan.to_dict(), updated_at=now)
                ent.plans[rec.key] = _better_plan(ent.plans.get(rec.key),
                                                  rec)
        self.record_device(calib=calib, samples=calib_samples, hub=hub)

    def record_drift(self, fp: str, sample) -> None:
        """Append one sim-vs-measured drift comparison to the
        fingerprint's bounded history.  ``sample`` is anything with the
        DriftRecord field surface (the obs plane's ``DriftSample``
        qualifies).  Nothing touches disk until ``flush()``."""
        rec = DriftRecord(
            t=float(getattr(sample, "t", 0.0)),
            job_id=str(getattr(sample, "job_id", "") or ""),
            predicted_peak=int(sample.predicted_peak),
            measured_peak=int(sample.measured_peak),
            peak_drift=float(sample.peak_drift),
            eor_drift=getattr(sample, "eor_drift", None),
            sp_drift=getattr(sample, "sp_drift", None))
        with self._lock:
            ent = self._pending.setdefault(fp, ExperienceEntry(fp))
            ent.drift.append(rec)
            del ent.drift[:-DRIFT_HISTORY_LIMIT]

    def drift_history(self, fp: str) -> List[DriftRecord]:
        """Persisted + pending drift samples for a fingerprint, time
        ordered, bounded to the history limit."""
        out: List[DriftRecord] = []
        ent = self.get(fp)
        if ent is not None:
            out.extend(ent.drift)
        with self._lock:
            pend = self._pending.get(fp)
            if pend is not None:
                out.extend(pend.drift)
        out.sort(key=lambda r: (r.t, r.job_id))
        return out[-DRIFT_HISTORY_LIMIT:]

    def record_device(self, calib: Optional[DeviceCalibration] = None,
                      samples: int = 0, hub=None) -> None:
        now = _time.time()
        dev = DeviceRecord(updated_at=now)
        if calib is not None:
            dev.calibration = CalibrationRecord(
                flops=calib.flops, mem_bw=calib.mem_bw,
                overhead_s=calib.overhead_s, samples=samples,
                updated_at=now)
        if hub is not None:
            for path, compressed in (("full", False), ("compressed", True)):
                n, nbytes, seconds = hub.transfer_totals(
                    compressed=compressed)
                if n:
                    dev.transfers[path] = {"n": float(n),
                                           "bytes": float(nbytes),
                                           "seconds": float(seconds)}
        with self._lock:
            self._pending_device = _merge_device(self._pending_device, dev)

    # -- atomic flush --------------------------------------------------
    def _atomic_write(self, path: str,
                      records: List[Dict[str, object]]) -> None:
        os.makedirs(self.dir, exist_ok=True)
        with self._lock:
            self._tmp_serial += 1
            serial = self._tmp_serial
        tmp = (f"{path}.tmp.{os.getpid()}."
               f"{threading.get_ident()}.{serial}")
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        os.replace(tmp, path)

    def flush(self) -> List[str]:
        """Merge every pending entry into the on-disk store.  Each file
        is read-merge-replace: the disk state read at flush time is
        merged with the pending entry (monotonic sample counts, best
        plan per slot) and written whole via an atomic ``os.replace`` —
        two processes flushing the same fingerprint cannot corrupt the
        file, and the loser of the race loses at most its own delta.
        Returns the fingerprints written."""
        with self._lock:
            pending = self._pending
            pending_dev = self._pending_device
            self._pending = {}
            self._pending_device = None
        written: List[str] = []
        for fp, entry in pending.items():
            disk = self.get(fp)
            merged = _merge_entries(disk, entry) if disk else entry
            self._atomic_write(self._path(fp), _records_of(merged))
            written.append(fp)
        if pending_dev is not None:
            merged_dev = _merge_device(self.device_record(), pending_dev)
            recs: List[Dict[str, object]] = [
                {"kind": "header", "schema": self.SCHEMA,
                 "fingerprint": f"device:{self.device_id}"}]
            if merged_dev.calibration is not None:
                recs.append({"kind": "calibration",
                             **dataclasses.asdict(merged_dev.calibration)})
            if merged_dev.transfers:
                recs.append({"kind": "transfers",
                             "transfers": merged_dev.transfers,
                             "updated_at": merged_dev.updated_at})
            self._atomic_write(self._device_path(), recs)
        return written

    # -- maintenance (tools/experience_torch.py) ------------------------
    def prune(self, min_samples: int = 0,
              max_age_days: Optional[float] = None) -> List[str]:
        """Drop entries below a sample floor or older than the age cap;
        returns the fingerprints removed."""
        cutoff = (None if max_age_days is None
                  else _time.time() - max_age_days * 86400.0)
        dropped: List[str] = []
        for fp in self.fingerprints():
            entry = self.get(fp)
            stale = entry is None \
                or entry.samples < min_samples \
                or (cutoff is not None and entry.updated_at < cutoff)
            if stale:
                try:
                    os.remove(self._path(fp))
                    dropped.append(fp)
                except OSError:
                    pass
        return dropped

    def export_bundle(self) -> Dict[str, object]:
        """One portable JSON document holding the whole store (for moving
        experience between machines of the same device class)."""
        bundle: Dict[str, object] = {
            "schema": self.SCHEMA, "device_id": self.device_id,
            "entries": {}, "device": None}
        for fp, entry in self.entries():
            bundle["entries"][fp] = _records_of(entry)[1:]  # sans header
        dev = self.device_record()
        if dev is not None:
            recs: List[Dict[str, object]] = []
            if dev.calibration is not None:
                recs.append({"kind": "calibration",
                             **dataclasses.asdict(dev.calibration)})
            if dev.transfers:
                recs.append({"kind": "transfers",
                             "transfers": dev.transfers,
                             "updated_at": dev.updated_at})
            bundle["device"] = recs
        return bundle

    def import_bundle(self, bundle: Dict[str, object]) -> int:
        """Merge an exported bundle into this store (same merge rules as
        concurrent flushes); returns the number of entries imported.
        A schema mismatch imports nothing."""
        if not isinstance(bundle, dict) \
                or bundle.get("schema") != self.SCHEMA:
            return 0
        n = 0
        for fp, recs in (bundle.get("entries") or {}).items():
            if not isinstance(recs, list):
                continue
            entry = _entry_of(str(fp), [r for r in recs
                                        if isinstance(r, dict)])
            with self._lock:
                cur = self._pending.get(fp)
                self._pending[fp] = _merge_entries(cur, entry) \
                    if cur else entry
            n += 1
        dev_recs = bundle.get("device")
        if isinstance(dev_recs, list):
            dev = DeviceRecord()
            for rec in dev_recs:
                if not isinstance(rec, dict):
                    continue
                body = {k: v for k, v in rec.items() if k != "kind"}
                try:
                    if rec.get("kind") == "calibration":
                        dev.calibration = _merge_calibration(
                            dev.calibration, CalibrationRecord(**body))
                    elif rec.get("kind") == "transfers":
                        dev.transfers.update(body.get("transfers", {}))
                        dev.updated_at = max(dev.updated_at,
                                             body.get("updated_at", 0.0))
                except TypeError:
                    continue
            with self._lock:
                self._pending_device = _merge_device(self._pending_device,
                                                     dev)
        self.flush()
        return n


# ----------------------------------------------------------------------
# Plan rebase (store timeline -> current timeline)
# ----------------------------------------------------------------------
def _rebase_plan(rec: PlanRecord,
                 seq: AccessSequence) -> Optional[SchedulingPlan]:
    """Project a stored plan onto the current sequence timeline.

    Events are (trigger op, Δt)-keyed, so the op anchors transfer across
    processes; absolute instants are recomputed from the CURRENT op-end
    times, with Δt scaled by the iteration-time ratio (a uniformly
    slower/faster calibration stretches every gap by the same factor).
    Transfer durations are kept as the plan was certified with them: the
    planner sizes them from the rate it measured or stored, which the
    profile's link rate need not be (the reference re-derives them from
    the profile, and a plan rebased onto its own timeline then verifies
    above its certified peak).  Any structural
    mismatch — an op index out of range, an unknown tensor, a size that
    changed — rejects the plan (None): the fingerprint should have
    prevented this, so a mismatch means the store entry is stale."""
    try:
        plan = SchedulingPlan.from_dict(rec.plan)
    except Exception:   # noqa: BLE001 - malformed stored plan
        return None
    n = len(seq.operators)
    scale = (seq.iteration_time / rec.iteration_time
             if rec.iteration_time > 0 else 1.0)
    for ev in plan.events:
        if not (-1 <= ev.trigger_op < n):
            return None
        if ev.target_op is not None and not (0 <= ev.target_op < n):
            return None
        spec = seq.tensors.get(ev.tensor_id)
        if spec is None or spec.size_bytes != ev.size_bytes:
            return None
        trig_end = seq.op_end[ev.trigger_op] if ev.trigger_op >= 0 else 0.0
        # (trigger, Δt) wraps modulo the iteration period; the stored
        # absolute start recovers which period copy the event lives in
        # (an Opt-phase swap-in scheduled across the boundary, paper
        # Fig. 1(c), belongs to the next iteration's prefix)
        k = int(ev.start // rec.iteration_time) if rec.iteration_time > 0 \
            else 0
        start = k * seq.iteration_time + trig_end \
            + max(ev.delta, 0.0) * scale
        if ev.event_type in (EventType.SWAP_OUT, EventType.SWAP_IN):
            # transfer durations are physical (the link, which the device
            # identity pins), not compute-scaled
            dur = max(ev.end - ev.start, 0.0)
        else:
            # recompute/release durations follow the compute timeline
            dur = max(ev.end - ev.start, 0.0) * scale
        ev.delta = max(ev.delta, 0.0) * scale
        ev.start, ev.end = start, start + dur
    plan._bump()               # in-place rebase: invalidate derived caches
    for tid, op in plan.release_after_op.items():
        if tid not in seq.tensors or not (0 <= op < n):
            return None
    plan.vanilla_peak_bytes = 0
    return plan
