"""tensile-trace-torch — record, validate and summarize the PyTorch port's
scheduling traces.

    PYTHONPATH=src python tools/tensile_trace_torch.py record \
        --out t.trace.json [--size small|medium|large] [--iterations N] \
        [--real] [--job-id j] [--device cuda|cpu]
    PYTHONPATH=src python tools/tensile_trace_torch.py validate t.trace.json
    PYTHONPATH=src python tools/tensile_trace_torch.py summary  t.trace.json
    PYTHONPATH=src python tools/tensile_trace_torch.py metrics-smoke \
        --root <dir> [--device cuda|cpu]

`record` captures the builtin "mlp" workload, plans it with the tensile
pipeline, runs the plan through the discrete-event simulator (default)
or the real ``FxExecutor`` (``--real``) with a ``TraceRecorder``
attached, and writes Chrome Trace Event Format JSON loadable in
Perfetto / chrome://tracing.  Both paths emit through the same
``TelemetryHub`` schemas, so a sim trace and a real trace of the same
job + plan diff side-by-side.  Safe points ride along as instants:
modeled (ledger-derived) for the sim run, measured (telemetry-derived)
for the real run — each on the clock the rest of that trace uses.

`metrics-smoke` is the CI self-check for the metrics endpoint: an
in-process ``SchedulerDaemon`` runs one small job to completion, and the
Prometheus text file it writes next to its heartbeat must parse and
carry the core gauge set.

The workload and the executor live on ``--device``: the CUDA card by
default (a missing card is an error), the CPU only when asked for; the
simulator needs no device but the capture does.  The port's counterpart
of ``tools/tensile_trace.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import (FxExecutor, MachineProfile,  # noqa: E402
                              MemoryEngine, TelemetryHub, capture_train_step,
                              find_safe_points, schedule_single, simulate)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.obs import (TraceRecorder, format_summary,  # noqa: E402
                             load_trace, parse_metrics_text, summarize_trace,
                             validate_chrome_trace)

# the CPU-sized device class the reference's test and scenario suites use
PROFILE = MachineProfile(host_link_bw=16e9, compute_flops=5e10, mem_bw=1e10)


def _capture(size: str, job_id: str, device):
    """Capture the builtin "mlp" workload at a size class on ``device``."""
    from repro_torch.service.workloads import make_mlp

    step_fn, params, opt_state, batch = make_mlp(size=size, device=device)
    seq, gm = capture_train_step(step_fn, params, opt_state, batch,
                                 job_id=job_id)
    return seq, gm, (params, opt_state, batch)


def cmd_record(args: argparse.Namespace) -> int:
    seq, gm, call_args = _capture(args.size, args.job_id,
                                  resolve_device(args.device))
    res = schedule_single(seq, profile=PROFILE)
    plan = res.plans[seq.job_id]
    budget = plan.planned_peak_bytes or None

    clock = "real" if args.real else "virtual"
    rec = TraceRecorder(clock=clock, budget_bytes=budget)
    rec.meta.update({"workload": f"mlp/{args.size}", "job_id": seq.job_id,
                     "runtime": "executor" if args.real else "simulator"})
    hub = TelemetryHub(clock=clock)
    eng = MemoryEngine(PROFILE, telemetry=hub)
    eng.attach_recorder(rec)

    if args.real:
        ex = FxExecutor(gm, seq, plan, engine=eng)
        for _ in range(args.iterations):
            ex.run(*call_args)
        ex.close()
        # measured safe points: detected from the run's own telemetry,
        # timestamped on the same wall clock as the rest of the trace
        sps = find_safe_points(seq, plan, source="measured", telemetry=hub)
    else:
        simulate([seq], {seq.job_id: plan}, PROFILE,
                 iterations=args.iterations, engine=eng, telemetry=hub)
        sps = find_safe_points(seq, plan)
    for sp in sps:
        rec.instant("safe_point", sp.time, job_id=seq.job_id,
                    op_idx=sp.op_idx)

    trace = rec.dump(args.out)
    errs = validate_chrome_trace(trace)
    if errs:
        for e in errs:
            print(f"INVALID: {e}", file=sys.stderr)
        return 1
    n = len(trace["traceEvents"])
    print(f"wrote {args.out}: {n} events ({clock} clock, "
          f"{args.iterations} iteration(s))")
    print(format_summary(summarize_trace(trace)))
    return 0


def cmd_validate(args: argparse.Namespace) -> int:
    trace = load_trace(args.path)
    errs = validate_chrome_trace(trace)
    for e in errs:
        print(f"INVALID: {e}", file=sys.stderr)
    if errs:
        return 1
    print(f"{args.path}: valid ({len(trace['traceEvents'])} events)")
    return 0


def cmd_summary(args: argparse.Namespace) -> int:
    trace = load_trace(args.path)
    summary = summarize_trace(trace, top=args.top)
    if args.json:
        print(json.dumps(summary, indent=1))
    else:
        print(format_summary(summary))
    return 0


# core gauges the daemon must always expose, whatever the workload did
_REQUIRED_METRICS = ("tensile_queue_depth", "tensile_capacity_bytes",
                     "tensile_reserved_bytes",
                     "tensile_state_transitions_total")


def cmd_metrics_smoke(args: argparse.Namespace) -> int:
    """CI self-check: an in-process daemon runs one job; its Prometheus
    text file must exist, parse, and carry the core gauge set."""
    from repro_torch.service import JobSpec, JobState, SchedulerDaemon

    os.makedirs(args.root, exist_ok=True)
    daemon = SchedulerDaemon(args.root, poll_interval=0.01,
                             controller_kwargs={"device": args.device})
    daemon.submit(JobSpec("metrics-smoke", workload="mlp",
                          workload_params={"size": "small"}, iterations=1))
    ok = daemon.drain(timeout=args.timeout)
    if not ok:
        print("FAIL: daemon did not drain", file=sys.stderr)
        return 1
    rec = daemon.store.get("metrics-smoke")
    if rec is None or rec.state is not JobState.DONE:
        state = rec.state.value if rec else "missing"
        print(f"FAIL: smoke job ended {state}", file=sys.stderr)
        return 1
    if not os.path.exists(daemon.metrics_path):
        print(f"FAIL: {daemon.metrics_path} not written", file=sys.stderr)
        return 1
    with open(daemon.metrics_path) as f:
        text = f.read()
    try:
        parsed = parse_metrics_text(text)
    except ValueError as exc:
        print(f"FAIL: metrics file does not parse: {exc}", file=sys.stderr)
        return 1
    names = {name for name, _labels in parsed}
    missing = [m for m in _REQUIRED_METRICS if m not in names]
    if missing:
        print(f"FAIL: metrics missing {missing} (got {sorted(names)})",
              file=sys.stderr)
        return 1
    if args.out:
        shutil.copyfile(daemon.metrics_path, args.out)
        print(f"copied metrics to {args.out}")
    print(f"metrics smoke OK: {len(parsed)} samples, "
          f"{len(names)} metrics ({daemon.metrics_path})")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(prog="tensile-trace-torch",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("record", help="run a workload and export a trace")
    p.add_argument("--out", default="tensile.trace.json")
    p.add_argument("--size", default="small",
                   choices=("small", "medium", "large"))
    p.add_argument("--iterations", type=int, default=2)
    p.add_argument("--job-id", default="trace0")
    p.add_argument("--real", action="store_true",
                   help="run the real FxExecutor instead of the "
                        "virtual-time simulator")
    p.add_argument("--device", default="cuda",
                   help="torch device of the workload (default: cuda; "
                        "'cpu' to opt in)")
    p.set_defaults(fn=cmd_record)

    p = sub.add_parser("validate", help="schema-check a trace file")
    p.add_argument("path")
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("summary", help="human summary of a trace file")
    p.add_argument("path")
    p.add_argument("--top", type=int, default=5,
                   help="swaps to list, by duration")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("metrics-smoke",
                       help="CI self-check of the daemon metrics endpoint")
    p.add_argument("--root", required=True)
    p.add_argument("--out", default=None,
                   help="also copy the metrics file here (CI artifact)")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--device", default="cuda",
                   help="torch device the daemon's job runs on "
                        "(default: cuda; 'cpu' to opt in)")
    p.set_defaults(fn=cmd_metrics_smoke)

    args = ap.parse_args()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
