"""The measured-telemetry plane: one sink for everything the runtimes
measure, and the queries every consumer of *measured* (not modeled) time
reads through.

TENSILE's across-iteration scheduling stays correct because runtime
measurements are folded back into the plan (EWMA latency correction,
paper §IV-E).  Before this module, only the scheduler's latency table was
corrected — safe-point detection, swap-window sizing and arbiter splits
all ran on modeled numbers.  ``TelemetryHub`` makes measurement a
first-class plane of the architecture:

  producers (one record schema, two clocks)
    * ``JaxprExecutor``  — per-op wall-clock latencies, per-transfer DMA
      durations (full-precision and compressed), stall events, and the
      per-job residency timeline (via the shared ``DeviceLedger`` hook),
      all in *real* time.
    * ``simulator.simulate`` — the SAME record shapes stamped in
      *virtual* time, so the two runtimes stay parity-testable
      (tests/test_engine_parity.py asserts identical schemas and
      identical residency-event ordering).

  consumers (each one a layer that used to read modeled numbers)
    * ``cost_model``   — ``CostModel.recalibrate`` re-fits the
      ``DeviceCalibration`` throughput constants online from hub op
      samples; ``calibration_report`` exposes per-primitive error.
    * ``engine.find_safe_points(source="measured")`` — quiescent local
      minima detected from the measured residency timeline, falling back
      to the modeled ledger below ``min_iterations`` of samples
      (cold-start blending, paper §IV-C).
    * ``SwapPlanner(telemetry=...)`` — swap windows sized from the
      measured DMA bandwidth instead of the profile constant.
    * ``BudgetArbiter`` — the ``eor-learned`` policy re-splits budgets by
      each job's measured stall share; drift replans trigger on
      ``drift_ratio`` instead of scheduler-private EWMA deltas.

The hub is append-only and thread-safe; producers never block on
consumers.  Records are grouped by the producing job's iteration counter
(``end_iteration`` advances it), so consumers can reason per-iteration —
the unit the paper's plans repeat over.

A copy of the JAX package's ``core/telemetry.py`` (which imports no JAX),
kept in step with it; the port's tests hold the two to the same
results.
"""
from __future__ import annotations

import dataclasses
import threading
import time as _time
from typing import Dict, List, Optional, Tuple

_EPS = 1e-12


# ----------------------------------------------------------------------
# Record shapes — identical for both runtimes (`t` is virtual seconds in
# the simulator, seconds since hub creation in the executor)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class OpSample:
    """One operator execution: measured latency + the static cost-model
    features (flops / bytes) needed to recalibrate throughput constants."""

    job_id: str
    iteration: int
    op_idx: int
    prim: str
    latency_s: float
    flops: float
    bytes_accessed: float
    t: float                 # instant the op COMPLETED


@dataclasses.dataclass
class TransferSample:
    """One host<->device DMA transfer (planned prefetch, eviction, or a
    passive swap-in stall fetch), full-precision or compressed."""

    job_id: str
    iteration: int
    storage: str
    direction: str           # "out" | "in"
    size_bytes: int
    duration_s: float
    compressed: bool
    passive: bool
    t: float                 # transfer START


@dataclasses.dataclass
class StallSample:
    """Compute blocked on memory: a late prefetch awaited or a passive
    swap-in serialized in front of an operator."""

    job_id: str
    iteration: int
    op_idx: int
    cause: str               # "await_prefetch" | "passive_in"
    duration_s: float
    t: float


@dataclasses.dataclass
class ResidencySample:
    """One byte-accounting mutation of the job's device residency,
    emitted by the shared ``DeviceLedger`` — so the executor's measured
    timeline and the simulator's virtual one are ordered identically by
    construction."""

    job_id: str
    iteration: int
    storage: str
    action: str              # "alloc" | "free"
    resident_bytes: int      # the JOB's bytes right after the mutation
    t: float


def record_schemas() -> Dict[str, Tuple[str, ...]]:
    """Field names per record type — the parity test asserts both
    runtimes emit exactly these shapes."""
    return {
        "op": tuple(f.name for f in dataclasses.fields(OpSample)),
        "transfer": tuple(f.name for f in dataclasses.fields(TransferSample)),
        "stall": tuple(f.name for f in dataclasses.fields(StallSample)),
        "residency": tuple(f.name
                           for f in dataclasses.fields(ResidencySample)),
    }


@dataclasses.dataclass
class IterationView:
    """One job-iteration's worth of records, time-aligned for safe-point
    detection: op completion instants, transfer busy intervals, and the
    residency timeline."""

    op_end: Dict[int, float]                 # op_idx -> completion instant
    transfers: List[Tuple[float, float]]     # busy [start, end) intervals
    residency: List[Tuple[float, int]]       # (t, job resident bytes)


# ----------------------------------------------------------------------
# The hub
# ----------------------------------------------------------------------
class TelemetryHub:
    """Single sink for measured runtime telemetry, shared by every job on
    a device (the Global Controller owns one per engine).

    ``clock`` is metadata only — "real" (executor wall clock, relative to
    hub creation) or "virtual" (simulator seconds); record shapes and
    query semantics are identical, which is what keeps the two runtimes
    parity-testable.
    """

    def __init__(self, clock: str = "real", ewma_alpha: float = 0.3):
        self.clock = clock
        self.ewma_alpha = ewma_alpha
        self._t0 = _time.perf_counter()
        self._lock = threading.Lock()
        # like EngineTrace.paused: a runtime doing harness work outside
        # the modeled iteration (e.g. materializing outputs) pauses
        # recording so steady-state telemetry is not polluted.  The flag
        # is PER-THREAD: under the multi-job controller one executor's
        # pause must not drop records from jobs running on other threads
        self._local = threading.local()
        self.ops: Dict[str, List[OpSample]] = {}
        self.transfers: Dict[str, List[TransferSample]] = {}
        self.stalls: Dict[str, List[StallSample]] = {}
        self.residency: Dict[str, List[ResidencySample]] = {}
        self._iter: Dict[str, int] = {}
        # per-job EWMA-corrected measured latency per op (paper §IV-E,
        # maintained incrementally as samples arrive)
        self._ewma: Dict[str, Dict[int, float]] = {}
        # optional observability tap: a TraceRecorder sees every sample
        # at its single publish point below.  None (the default) keeps
        # the hot path at one attribute check per record.
        self._recorder = None

    def attach_recorder(self, recorder) -> None:
        """Forward every published sample to a trace recorder."""
        self._recorder = recorder

    # -- pause (per-thread) --------------------------------------------
    @property
    def paused(self) -> bool:
        return getattr(self._local, "paused", False)

    @paused.setter
    def paused(self, value: bool) -> None:
        self._local.paused = bool(value)

    # -- buffered appends (per-thread, executor hot path) --------------
    # A producer that records per op can opt into buffering: record_*
    # calls append fully-stamped samples to a thread-local list without
    # touching the hub lock, and ``flush()`` publishes them — in emission
    # order, under ONE lock acquisition — at op boundaries.  Samples are
    # stamped (clock + iteration index) at record time, so buffering
    # changes only lock traffic, never record content or order.
    @property
    def buffering(self) -> bool:
        return getattr(self._local, "buffer", None) is not None

    def _buffer(self):
        return getattr(self._local, "buffer", None)

    def begin_buffering(self) -> None:
        if self._buffer() is None:
            self._local.buffer = []

    def flush(self) -> None:
        buf = self._buffer()
        if not buf:
            return
        self._local.buffer = []
        with self._lock:
            for kind, s in buf:
                self._publish(kind, s)

    def end_buffering(self) -> None:
        self.flush()
        self._local.buffer = None

    def _publish(self, kind: str, s) -> None:
        """Append one stamped sample to its stream (hub lock held)."""
        if kind == "op":
            self.ops.setdefault(s.job_id, []).append(s)
            ew = self._ewma.setdefault(s.job_id, {})
            old = ew.get(s.op_idx)
            ew[s.op_idx] = s.latency_s if old is None else (
                self.ewma_alpha * s.latency_s
                + (1 - self.ewma_alpha) * old)
        elif kind == "transfer":
            self.transfers.setdefault(s.job_id, []).append(s)
        elif kind == "stall":
            self.stalls.setdefault(s.job_id, []).append(s)
        else:
            self.residency.setdefault(s.job_id, []).append(s)
        rec = self._recorder
        if rec is not None:
            rec.on_sample(kind, s)

    # -- clock ---------------------------------------------------------
    def now(self) -> float:
        return _time.perf_counter() - self._t0

    def _stamp(self, t: Optional[float]) -> float:
        return self.now() if t is None else t

    def _it(self, job_id: str) -> int:
        return self._iter.get(job_id, 0)

    # -- producers -----------------------------------------------------
    def record_op(self, job_id: str, op_idx: int, latency_s: float,
                  prim: str = "", flops: float = 0.0,
                  bytes_accessed: float = 0.0,
                  t: Optional[float] = None) -> None:
        if self.paused:
            return
        s = OpSample(job_id, self._it(job_id), op_idx, prim, latency_s,
                     flops, bytes_accessed, self._stamp(t))
        buf = self._buffer()
        if buf is not None:
            buf.append(("op", s))
            return
        with self._lock:
            self._publish("op", s)

    def record_transfer(self, job_id: str, storage: str, direction: str,
                        size_bytes: int, duration_s: float,
                        compressed: bool = False, passive: bool = False,
                        t: Optional[float] = None) -> None:
        if self.paused:
            return
        s = TransferSample(job_id, self._it(job_id), storage, direction,
                           int(size_bytes), duration_s, compressed, passive,
                           self._stamp(t))
        buf = self._buffer()
        if buf is not None:
            buf.append(("transfer", s))
            return
        with self._lock:
            self._publish("transfer", s)

    def record_stall(self, job_id: str, op_idx: int, duration_s: float,
                     cause: str, t: Optional[float] = None) -> None:
        if self.paused:
            return
        s = StallSample(job_id, self._it(job_id), op_idx, cause, duration_s,
                        self._stamp(t))
        buf = self._buffer()
        if buf is not None:
            buf.append(("stall", s))
            return
        with self._lock:
            self._publish("stall", s)

    def record_residency(self, job_id: str, storage: str, action: str,
                         resident_bytes: int,
                         t: Optional[float] = None) -> None:
        if self.paused:
            return
        s = ResidencySample(job_id, self._it(job_id), storage, action,
                            int(resident_bytes), self._stamp(t))
        buf = self._buffer()
        if buf is not None:
            buf.append(("residency", s))
            return
        with self._lock:
            self._publish("residency", s)

    def end_iteration(self, job_id: str) -> int:
        """Mark the job's iteration boundary; records after this carry
        the next iteration index.  Returns the completed count."""
        self.flush()
        with self._lock:
            n = self._iter.get(job_id, 0) + 1
            self._iter[job_id] = n
            return n

    # -- queries: latency ----------------------------------------------
    def iterations(self, job_id: str) -> int:
        """Completed (fully recorded) iterations of the job."""
        return self._iter.get(job_id, 0)

    def jobs(self) -> List[str]:
        with self._lock:
            seen = (set(self.ops) | set(self.transfers)
                    | set(self.stalls) | set(self.residency))
            return sorted(seen)

    def has_samples(self, job_id: str) -> bool:
        """Whether the job has produced any measured records yet — the
        arbiter's learned policies fall back to persisted experience
        priors for jobs that have not."""
        with self._lock:
            return bool(self.ops.get(job_id) or self.stalls.get(job_id))

    def op_summary(self, job_id: str) -> Dict[str, Dict[str, float]]:
        """Per-primitive distilled latency fit of one job's op samples:
        ``{prim: {n, flops, bytes, latency_s}}`` with the three numeric
        fields as MEANS — the persistent form the experience store keeps
        per fingerprint (enough to re-fit throughput constants without
        replaying raw samples)."""
        with self._lock:
            acc: Dict[str, Dict[str, float]] = {}
            for s in self.ops.get(job_id, ()):
                d = acc.setdefault(s.prim or "?", {
                    "n": 0.0, "flops": 0.0, "bytes": 0.0, "latency_s": 0.0})
                d["n"] += 1
                d["flops"] += s.flops
                d["bytes"] += s.bytes_accessed
                d["latency_s"] += s.latency_s
        for d in acc.values():
            n = max(d["n"], 1.0)
            d["flops"] /= n
            d["bytes"] /= n
            d["latency_s"] /= n
        return acc

    def op_latencies(self, job_id: str) -> Dict[int, float]:
        """EWMA-corrected measured latency per op index (§IV-E)."""
        with self._lock:
            return dict(self._ewma.get(job_id, {}))

    def latency_sum(self, job_id: str) -> float:
        with self._lock:
            return sum(self._ewma.get(job_id, {}).values())

    def drift_ratio(self, job_id: str, baseline_sum: float) -> float:
        """Relative drift of the measured (EWMA) iteration latency vs the
        sum the current plan was built from — the replan trigger that
        used to live in scheduler-private EWMA deltas (§IV-E)."""
        s = self.latency_sum(job_id)
        if not s:
            return 0.0
        if baseline_sum <= 0:
            return float("inf")
        return abs(s - baseline_sum) / baseline_sum

    # -- queries: transfers --------------------------------------------
    def measured_bandwidth(self, compressed: bool = False,
                           min_samples: int = 3,
                           min_bytes: int = 1) -> Optional[float]:
        """Effective DMA bandwidth (source bytes per second) over every
        recorded transfer of the given path; None below ``min_samples``
        (cold start — callers fall back to the profile constant)."""
        with self._lock:
            tot_b = tot_s = 0.0
            n = 0
            for recs in self.transfers.values():
                for r in recs:
                    if r.compressed != compressed or r.size_bytes < min_bytes:
                        continue
                    tot_b += r.size_bytes
                    tot_s += r.duration_s
                    n += 1
        if n < min_samples or tot_s <= _EPS:
            return None
        return tot_b / tot_s

    def transfer_totals(self, compressed: bool = False,
                        min_bytes: int = 1,
                        job_id: Optional[str] = None
                        ) -> Tuple[int, int, float]:
        """(transfers, source bytes, busy seconds) over recorded
        transfers of the given path — hub-wide by default, one job's
        with ``job_id`` — the cumulative form the experience store
        persists so a future cold start can seed ``measured_bandwidth``
        before any live sample exists."""
        with self._lock:
            tot_b = 0
            tot_s = 0.0
            n = 0
            streams = ([self.transfers.get(job_id, [])]
                       if job_id is not None
                       else list(self.transfers.values()))
            for recs in streams:
                for r in recs:
                    if r.compressed != compressed or r.size_bytes < min_bytes:
                        continue
                    tot_b += r.size_bytes
                    tot_s += r.duration_s
                    n += 1
        return n, tot_b, tot_s

    def total_op_samples(self) -> int:
        """Hub-wide op-sample count, read under the hub lock (callers
        must not iterate ``ops`` themselves while producers insert)."""
        with self._lock:
            return sum(len(v) for v in self.ops.values())

    # -- queries: stalls / EOR -----------------------------------------
    def stall_share(self, job_id: str) -> float:
        """Fraction of the job's measured time lost to memory stalls:
        stall seconds / (op seconds + stall seconds).  0.0 with no
        samples — a cold job bids the neutral weight."""
        with self._lock:
            op_s = sum(s.latency_s for s in self.ops.get(job_id, ()))
            st_s = sum(s.duration_s for s in self.stalls.get(job_id, ()))
        tot = op_s + st_s
        return st_s / tot if tot > _EPS else 0.0

    def measured_eor(self, job_id: str) -> float:
        """Measured extra-overhead ratio: stall time over pure compute
        time — the runtime analogue of the paper's EOR, per job."""
        with self._lock:
            op_s = sum(s.latency_s for s in self.ops.get(job_id, ()))
            st_s = sum(s.duration_s for s in self.stalls.get(job_id, ()))
        return st_s / op_s if op_s > _EPS else 0.0

    # -- queries: residency --------------------------------------------
    def residency_timeline(self, job_id: str) -> List[Tuple[float, int]]:
        with self._lock:
            return [(r.t, r.resident_bytes)
                    for r in self.residency.get(job_id, ())]

    def residency_keys(self, job_id: str) -> List[Tuple[str, str]]:
        """(action, storage) in emission order — what the sim-vs-real
        parity test compares."""
        with self._lock:
            return [(r.action, r.storage)
                    for r in self.residency.get(job_id, ())]

    # -- queries: per-iteration views ----------------------------------
    def iteration_view(self, job_id: str,
                       iteration: int) -> Optional[IterationView]:
        """Time-aligned records of one completed iteration, or None when
        the iteration has no op samples (not instrumented)."""
        with self._lock:
            ops = [s for s in self.ops.get(job_id, ())
                   if s.iteration == iteration]
            if not ops:
                return None
            op_end = {}
            for s in ops:
                op_end[s.op_idx] = s.t
            transfers = [(r.t, r.t + r.duration_s)
                         for r in self.transfers.get(job_id, ())
                         if r.iteration == iteration]
            residency = [(r.t, r.resident_bytes)
                         for r in self.residency.get(job_id, ())
                         if r.iteration <= iteration]
        # residency carries over iterations: keep only the last sample
        # at-or-before the window plus everything inside it
        lo = min(op_end.values()) if op_end else 0.0
        inside = [(t, b) for t, b in residency if t >= lo - _EPS]
        before = [(t, b) for t, b in residency if t < lo - _EPS]
        if before:
            inside.insert(0, before[-1])
        return IterationView(op_end=op_end, transfers=transfers,
                             residency=inside)

    def measured_boundary_residency(
            self, job_id: str, iteration: int,
            n_ops: int) -> Optional[List[int]]:
        """The job's measured resident bytes at every op boundary of one
        iteration (last residency sample at or before each op's measured
        completion instant); None when the iteration is missing ops."""
        view = self.iteration_view(job_id, iteration)
        if view is None or len(view.op_end) < n_ops:
            return None
        out: List[int] = []
        # stable sort on time ONLY: an op's allocs and frees share one
        # stamp (the op's end instant), and emission order — not byte
        # count — decides which value the boundary settles at
        res = sorted(view.residency, key=lambda r: r[0])
        cur = res[0][1] if res else 0
        ri = 0
        for k in range(n_ops):
            t_k = view.op_end.get(k)
            if t_k is None:
                return None
            while ri < len(res) and res[ri][0] <= t_k + _EPS:
                cur = res[ri][1]
                ri += 1
            out.append(cur)
        return out

    def quiescent_boundaries(self, job_id: str, iteration: int,
                             n_ops: int) -> Optional[List[int]]:
        """Op boundaries of one iteration with NO measured transfer in
        flight across the completion instant — the measured analogue of
        the modeled busy-interval check in ``engine.find_safe_points``."""
        view = self.iteration_view(job_id, iteration)
        if view is None or len(view.op_end) < n_ops:
            return None
        out: List[int] = []
        for k in range(n_ops):
            t_k = view.op_end.get(k)
            if t_k is None:
                return None
            if any(s < t_k - _EPS and t_k < e - _EPS
                   for s, e in view.transfers):
                continue
            out.append(k)
        return out
