"""Chrome Trace Event Format export of a scheduling run.

The recorder taps the telemetry plane at its single publish point
(``TelemetryHub._publish``) plus a handful of instant hooks (plan
hot-swaps, DMA batch merges, daemon state transitions), buffers the raw
samples, and renders them to Chrome Trace Event Format JSON on demand —
one track per job, one DMA-channel track, per-job residency and
device-budget counter tracks.  Because both runtimes emit through the
same hub schemas, a virtual-time (simulator) trace and a wall-clock
(executor) trace of the same job + plan diff side-by-side.

Track layout (pid 1 = the device):

- ``tid 1..N`` — one per job (op spans, stall spans, hot-swap instants)
- ``tid 1000`` — the DMA channel (swap/prefetch spans, batch instants)
- ``tid 1001`` — structured events forwarded from an ``EventLog``
- counter tracks — ``resident:<job>``, ``device_used_bytes``,
  ``device_budget_bytes``

Timestamps: virtual-clock seconds (simulator) or hub-relative wall
seconds (executor), both scaled to microseconds and shifted so the
earliest event sits at ts=0 — the two clocks are distinguished only by
the ``otherData.clock`` field.

A copy of the JAX package's ``obs/trace.py`` (plain Python), kept in step
with it: the recorder reads the port hub's sample schemas
(``core/telemetry.py``, the same fields as the reference's), so a trace
of the same plan renders the same JSON from either package.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

TRACE_SCHEMA_VERSION = 1

# fixed tids for the non-job tracks; job tracks allocate from 1 upward
DMA_TID = 1000
EVENTS_TID = 1001

_S_TO_US = 1e6


class TraceRecorder:
    """Buffer of structured trace events, rendered lazily by
    :meth:`to_chrome`.

    The hot-path surface is two tiny methods — :meth:`on_sample` (called
    under the hub lock from ``TelemetryHub._publish``) and
    :meth:`instant` — so an attached recorder costs one list append per
    record; an unattached one costs a single ``is not None`` check at
    each hook site.
    """

    def __init__(self, clock: str = "virtual",
                 budget_bytes: Optional[int] = None):
        self.clock = clock
        self.budget_bytes = budget_bytes
        # raw telemetry samples in publish order: (kind, sample)
        self.samples: List[Tuple[str, Any]] = []
        # extra structured events: dicts with a "ph"-like "type" key
        self.extras: List[Dict[str, Any]] = []
        self.meta: Dict[str, Any] = {}

    # -- producer hooks (hot path: keep these minimal) ------------------
    def on_sample(self, kind: str, s) -> None:
        """Tap point for ``TelemetryHub._publish`` (hub lock held)."""
        self.samples.append((kind, s))

    def instant(self, name: str, t: float, job_id: Optional[str] = None,
                **args) -> None:
        self.extras.append({"type": "instant", "name": name, "t": t,
                            "job_id": job_id, "args": args})

    def span(self, name: str, t: float, dur: float,
             job_id: Optional[str] = None, cat: str = "span",
             **args) -> None:
        self.extras.append({"type": "span", "name": name, "t": t,
                            "dur": dur, "job_id": job_id, "cat": cat,
                            "args": args})

    def counter(self, name: str, t: float, value: float) -> None:
        self.extras.append({"type": "counter", "name": name, "t": t,
                            "value": value})

    # -- export ---------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """Render the buffered stream as a Chrome Trace Event Format
        dict (``json.dump`` it, load in chrome://tracing or Perfetto)."""
        events: List[Dict[str, Any]] = []
        tids: Dict[str, int] = {}

        def job_tid(job_id: Optional[str]) -> int:
            key = f"job:{job_id}" if job_id is not None else "events"
            if key == "events":
                return EVENTS_TID
            if key not in tids:
                tids[key] = 1 + len(tids)
            return tids[key]

        # pass 1: translate samples/extras into (ts, event) with raw
        # second timestamps; shift to zero afterwards
        raw: List[Tuple[float, Dict[str, Any]]] = []
        # replay per-job residency to derive the device-wide used curve
        job_resident: Dict[str, int] = {}
        used_curve: List[Tuple[float, int]] = []

        for kind, s in self.samples:
            if kind == "op":
                ts = s.t - s.latency_s
                raw.append((ts, {
                    "name": s.prim or f"op{s.op_idx}", "cat": "op",
                    "ph": "X", "ts": ts, "dur": s.latency_s,
                    "pid": 1, "tid": job_tid(s.job_id),
                    "args": {"job": s.job_id, "op_idx": s.op_idx,
                             "iteration": s.iteration}}))
            elif kind == "transfer":
                raw.append((s.t, {
                    "name": f"{s.direction}:{s.storage}", "cat": "transfer",
                    "ph": "X", "ts": s.t, "dur": s.duration_s,
                    "pid": 1, "tid": DMA_TID,
                    "args": {"job": s.job_id, "storage": s.storage,
                             "direction": s.direction,
                             "size_bytes": s.size_bytes,
                             "compressed": s.compressed,
                             "passive": s.passive,
                             "iteration": s.iteration}}))
            elif kind == "stall":
                ts = s.t - s.duration_s
                raw.append((ts, {
                    "name": s.cause, "cat": "stall",
                    "ph": "X", "ts": ts, "dur": s.duration_s,
                    "pid": 1, "tid": job_tid(s.job_id),
                    "args": {"job": s.job_id, "op_idx": s.op_idx,
                             "iteration": s.iteration}}))
            else:  # residency
                raw.append((s.t, {
                    "name": f"resident:{s.job_id}", "cat": "residency",
                    "ph": "C", "ts": s.t, "pid": 1,
                    "args": {"bytes": s.resident_bytes}}))
                job_resident[s.job_id] = s.resident_bytes
                used_curve.append((s.t, sum(job_resident.values())))

        for t, used in used_curve:
            raw.append((t, {"name": "device_used_bytes", "cat": "residency",
                            "ph": "C", "ts": t, "pid": 1,
                            "args": {"bytes": used}}))

        for ev in self.extras:
            if ev["type"] == "instant":
                raw.append((ev["t"], {
                    "name": ev["name"], "cat": "event", "ph": "i",
                    "ts": ev["t"], "pid": 1, "tid": job_tid(ev["job_id"]),
                    "s": "t" if ev["job_id"] is not None else "g",
                    "args": dict(ev["args"])}))
            elif ev["type"] == "span":
                raw.append((ev["t"], {
                    "name": ev["name"], "cat": ev["cat"], "ph": "X",
                    "ts": ev["t"], "dur": ev["dur"],
                    "pid": 1, "tid": job_tid(ev["job_id"]),
                    "args": dict(ev["args"])}))
            else:  # counter
                raw.append((ev["t"], {
                    "name": ev["name"], "cat": "counter", "ph": "C",
                    "ts": ev["t"], "pid": 1,
                    "args": {"value": ev["value"]}}))

        t0 = min((t for t, _ in raw), default=0.0)
        t1 = max((t for t, _ in raw), default=0.0)

        # the device budget: a flat counter track bracketing the run,
        # plus a global instant at every upward crossing of used > budget
        if self.budget_bytes is not None:
            for t in (t0, t1):
                raw.append((t, {"name": "device_budget_bytes",
                                "cat": "counter", "ph": "C", "ts": t,
                                "pid": 1,
                                "args": {"bytes": int(self.budget_bytes)}}))
            over = False
            for t, used in used_curve:
                now_over = used > self.budget_bytes
                if now_over and not over:
                    raw.append((t, {"name": "budget_violation",
                                    "cat": "event", "ph": "i", "ts": t,
                                    "pid": 1, "tid": EVENTS_TID, "s": "g",
                                    "args": {"used_bytes": used,
                                             "budget_bytes":
                                                 int(self.budget_bytes)}}))
                over = now_over

        for _, ev in raw:
            ev["ts"] = round((ev["ts"] - t0) * _S_TO_US, 3)
            if "dur" in ev:
                ev["dur"] = round(max(ev["dur"], 0.0) * _S_TO_US, 3)
            events.append(ev)

        # metadata: process + thread names, emitted for every tid in use
        meta_events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": 1,
            "args": {"name": f"tensile ({self.clock} clock)"}}]
        for key, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta_events.append({"name": "thread_name", "ph": "M", "pid": 1,
                                "tid": tid, "args": {"name": key}})
        if any(e.get("tid") == DMA_TID for e in events):
            meta_events.append({"name": "thread_name", "ph": "M", "pid": 1,
                                "tid": DMA_TID, "args": {"name": "dma"}})
        if any(e.get("tid") == EVENTS_TID for e in events):
            meta_events.append({"name": "thread_name", "ph": "M", "pid": 1,
                                "tid": EVENTS_TID, "args": {"name": "events"}})

        other = {"clock": self.clock, "schema": TRACE_SCHEMA_VERSION}
        other.update(self.meta)
        return {"traceEvents": meta_events + events,
                "displayTimeUnit": "ms",
                "otherData": other}

    def dump(self, path: str) -> Dict[str, Any]:
        """Atomically write the Chrome trace JSON; returns the dict."""
        trace = self.to_chrome()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(trace, f, indent=1)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return trace


# ---------------------------------------------------------------- schema
_KNOWN_PH = {"X", "i", "I", "C", "M", "B", "E"}


def validate_chrome_trace(trace: Any) -> List[str]:
    """Validate a dict against the Chrome Trace Event Format subset the
    recorder emits.  Returns a list of error strings — empty means
    valid.  Strict enough that a malformed export can't slip into CI
    artifacts, loose enough to accept any viewer-loadable trace."""
    errs: List[str] = []
    if not isinstance(trace, dict):
        return [f"trace must be a JSON object, got {type(trace).__name__}"]
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents must be a list"]
    if not evs:
        errs.append("traceEvents is empty")
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _KNOWN_PH:
            errs.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errs.append(f"{where}: missing name")
        if ph == "M":
            if ev["name"] not in ("process_name", "thread_name"):
                errs.append(f"{where}: metadata name {ev['name']!r}")
            elif not isinstance(ev.get("args", {}).get("name"), str):
                errs.append(f"{where}: metadata args.name missing")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"{where}: bad ts {ts!r}")
        if not isinstance(ev.get("pid"), int):
            errs.append(f"{where}: bad pid")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: complete event with bad dur {dur!r}")
            if not isinstance(ev.get("tid"), int):
                errs.append(f"{where}: complete event without tid")
        elif ph in ("i", "I"):
            if ev.get("s", "t") not in ("t", "p", "g"):
                errs.append(f"{where}: instant scope {ev.get('s')!r}")
        elif ph == "C":
            args = ev.get("args")
            if (not isinstance(args, dict) or not args
                    or not all(isinstance(v, (int, float))
                               for v in args.values())):
                errs.append(f"{where}: counter args must be numbers")
    return errs


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------- summary
def summarize_trace(trace: Dict[str, Any], top: int = 5) -> Dict[str, Any]:
    """Distill a trace for humans: top swaps by duration, per-job stall
    share, budget-violation instants, and track inventory."""
    evs = [e for e in trace.get("traceEvents", [])
           if isinstance(e, dict) and e.get("ph") != "M"]
    transfers = [e for e in evs
                 if e.get("ph") == "X" and e.get("cat") == "transfer"]
    transfers.sort(key=lambda e: -e.get("dur", 0.0))
    ops: Dict[str, float] = {}
    stalls: Dict[str, float] = {}
    for e in evs:
        if e.get("ph") != "X":
            continue
        job = e.get("args", {}).get("job")
        if job is None:
            continue
        if e.get("cat") == "op":
            ops[job] = ops.get(job, 0.0) + e.get("dur", 0.0)
        elif e.get("cat") == "stall":
            stalls[job] = stalls.get(job, 0.0) + e.get("dur", 0.0)
    stall_share = {
        j: (stalls.get(j, 0.0) / (ops[j] + stalls.get(j, 0.0))
            if ops[j] + stalls.get(j, 0.0) > 0 else 0.0)
        for j in ops}
    violations = [e for e in evs if e.get("name") == "budget_violation"]
    hot_swaps = [e for e in evs if e.get("name") == "hot_swap"]
    counters = sorted({e["name"] for e in evs if e.get("ph") == "C"})
    return {
        "events": len(evs),
        "jobs": sorted(ops),
        "counters": counters,
        "top_swaps": [{"name": e["name"], "dur_us": e.get("dur", 0.0),
                       "ts_us": e.get("ts", 0.0),
                       "job": e.get("args", {}).get("job")}
                      for e in transfers[:top]],
        "transfer_count": len(transfers),
        "stall_share": stall_share,
        "budget_violations": [{"ts_us": e.get("ts", 0.0),
                               "used_bytes":
                                   e.get("args", {}).get("used_bytes")}
                              for e in violations],
        "hot_swaps": [{"ts_us": e.get("ts", 0.0),
                       "args": e.get("args", {})} for e in hot_swaps],
    }


def format_summary(summary: Dict[str, Any]) -> str:
    lines = [f"events: {summary['events']}  jobs: "
             f"{', '.join(summary['jobs']) or '-'}",
             f"counter tracks: {', '.join(summary['counters']) or '-'}",
             f"transfers: {summary['transfer_count']}"]
    if summary["top_swaps"]:
        lines.append("top swaps by duration:")
        for s in summary["top_swaps"]:
            lines.append(f"  {s['name']:<28} {s['dur_us']:>12.1f} us "
                         f"@ {s['ts_us']:.1f} us ({s['job']})")
    if summary["stall_share"]:
        lines.append("stall share:")
        for j, sh in sorted(summary["stall_share"].items()):
            lines.append(f"  {j:<28} {100 * sh:6.2f} %")
    lines.append(f"hot swaps: {len(summary['hot_swaps'])}")
    if summary["budget_violations"]:
        lines.append(f"budget violations: "
                     f"{len(summary['budget_violations'])}")
        for v in summary["budget_violations"]:
            lines.append(f"  over budget at {v['ts_us']:.1f} us "
                         f"(used {v['used_bytes']})")
    else:
        lines.append("budget violations: 0")
    return "\n".join(lines)
