"""tensile-svc-torch — operate the PyTorch port's scheduler daemon.

    PYTHONPATH=src python tools/tensile_svc_torch.py start  --root <dir> \
        [--device cuda|cpu] [--capacity-bytes N] [--poll-interval S]
    PYTHONPATH=src python tools/tensile_svc_torch.py submit --root <dir> \
        --job-id j1 --workload mlp [--params '{"size": "small"}'] \
        [--iterations N] [--priority P] [--budget-hint-bytes N] [--wait]
    PYTHONPATH=src python tools/tensile_svc_torch.py submit --root <dir> \
        --job-id s1 --kind serve [--arch tinyllama-1.1b] [--requests N] \
        [--trace steady|burst|poisson] [--prompt-len N] [--gen N] [--wait]
    PYTHONPATH=src python tools/tensile_svc_torch.py status --root <dir> [--json]
    PYTHONPATH=src python tools/tensile_svc_torch.py metrics --root <dir> [--parsed]
    PYTHONPATH=src python tools/tensile_svc_torch.py drain  --root <dir> [--wait]
    PYTHONPATH=src python tools/tensile_svc_torch.py smoke  --root <dir> \
        [--device cuda|cpu]

`start` runs the ``SchedulerDaemon`` event loop in the foreground until
stopped or drained.  `submit`/`status`/`drain` are thin wrappers over
``ServiceClient`` — they share only the service root directory with the
daemon (filesystem inbox + durable job store), so they work from any
process.  `smoke` is the CI end-to-end self-check: it starts a daemon
subprocess, submits three jobs over the wire, drains, then simulates a
daemon crash mid-run and asserts the restarted daemon recovers the full
queue state (QUEUED/ADMITTED replayed, the RUNNING orphan re-queued
exactly once) and runs it to completion.

The daemon's controller, and every job it runs, live on ``--device``: the
CUDA card by default (a missing card is an error), the CPU only when asked
for.  The port's counterpart of ``tools/tensile_svc.py``; both write and
read the same service root formats.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.service import (JobRecord, JobSpec,  # noqa: E402
                                 JobState, JobStore, SchedulerDaemon,
                                 ServeParams, ServiceClient)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GiB"


def _daemon(root: str, device: str, capacity_bytes=None,
            poll_interval: float = 0.05) -> SchedulerDaemon:
    """A daemon whose controller owns ``device``."""
    return SchedulerDaemon(root, capacity_bytes=capacity_bytes,
                           poll_interval=poll_interval,
                           controller_kwargs={"device": device})


def cmd_start(args: argparse.Namespace) -> int:
    daemon = _daemon(args.root, args.device, args.capacity_bytes,
                     args.poll_interval)
    rec = daemon.recovered
    print(f"daemon up at {args.root} (pid {os.getpid()}, "
          f"{daemon.controller.device}, capacity "
          f"{_fmt_bytes(daemon.capacity_bytes)}); recovered "
          f"{len(rec['replayed'])} queued, "
          f"{len(rec['requeued_orphans'])} re-queued orphan(s), "
          f"{len(rec['failed_orphans'])} failed orphan(s)", flush=True)
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        daemon.stop()
    print("daemon stopped", flush=True)
    return 0


def cmd_submit(args: argparse.Namespace) -> int:
    serve = None
    if args.kind == "serve":
        serve = ServeParams(arch=args.arch, max_sequences=args.max_sequences,
                            n_requests=args.requests,
                            prompt_len=args.prompt_len, gen_len=args.gen,
                            trace=args.trace, block_tokens=args.block_tokens)
    spec = JobSpec(args.job_id, kind=args.kind, serve=serve,
                   workload=args.workload,
                   workload_params=json.loads(args.params),
                   iterations=args.iterations, priority=args.priority,
                   budget_hint_bytes=args.budget_hint_bytes)
    client = ServiceClient(args.root)
    client.submit(spec)
    print(f"submitted {spec.job_id} -> {client.inbox}")
    if args.wait:
        records = client.wait([spec.job_id], timeout=args.timeout)
        rec = records[spec.job_id]
        print(f"{rec.job_id}: {rec.state.value}"
              + (f" ({rec.error})" if rec.error else ""))
        return 0 if rec.state is JobState.DONE else 1
    return 0


def cmd_status(args: argparse.Namespace) -> int:
    client = ServiceClient(args.root)
    hb = client.heartbeat()
    if args.json:
        records = client.status()
        print(json.dumps({
            "heartbeat": hb,
            "daemon_alive": client.daemon_alive(),
            "jobs": {jid: rec.to_dict()
                     for jid, rec in sorted(records.items())},
        }, indent=1, sort_keys=True))
        return 0
    if hb:
        alive = "alive" if client.daemon_alive() else "stale"
        print(f"daemon: {hb.get('state')} ({alive}, pid {hb.get('pid')}), "
              f"reserved {_fmt_bytes(hb.get('reserved_bytes', 0))} / "
              f"{_fmt_bytes(hb.get('capacity_bytes', 0))}, "
              f"{hb.get('waiting', 0)} waiting")
    else:
        print("daemon: no heartbeat")
    records = client.status()
    if not records:
        print("no jobs")
        return 0
    for jid, rec in sorted(records.items()):
        peak = (f" measured={_fmt_bytes(rec.measured_peak_bytes)}"
                if rec.measured_peak_bytes else "")
        pred = (f" predicted={_fmt_bytes(rec.predicted_peak_bytes)}"
                f"[{rec.predicted_source}]"
                if rec.predicted_peak_bytes else "")
        err = f" error={rec.error}" if rec.error else ""
        print(f"  {jid}: {rec.state.value}{pred}{peak}"
              f" requeues={rec.requeues}{err}")
    return 0


def cmd_metrics(args: argparse.Namespace) -> int:
    """Print the daemon's Prometheus text exposition (validated)."""
    from repro_torch.obs import parse_metrics_text

    path = os.path.join(args.root, "metrics.prom")
    if not os.path.exists(path):
        print(f"no metrics file at {path} (daemon not started?)",
              file=sys.stderr)
        return 1
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    try:
        parsed = parse_metrics_text(text)
    except ValueError as exc:
        print(f"metrics file does not parse: {exc}", file=sys.stderr)
        return 1
    if args.parsed:
        for (name, labels), value in sorted(parsed.items()):
            lbl = ("{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"
                   if labels else "")
            print(f"{name}{lbl} {value}")
    else:
        sys.stdout.write(text)
    return 0


def cmd_drain(args: argparse.Namespace) -> int:
    client = ServiceClient(args.root)
    client.drain()
    print("drain requested")
    if args.wait:
        deadline = time.time() + args.timeout
        while client.daemon_alive() and time.time() < deadline:
            time.sleep(0.1)
        if client.daemon_alive():
            print(f"daemon still running after {args.timeout}s")
            return 1
        print("daemon drained and stopped")
    return 0


# ---------------------------------------------------------------- smoke
def _check(ok: bool, what: str) -> None:
    print(("  ok  " if ok else "  FAIL") + f" {what}")
    if not ok:
        raise SystemExit(f"service smoke failed: {what}")


def cmd_smoke(args: argparse.Namespace) -> int:
    """CI end-to-end: wire submission + drain, then crash recovery."""
    root = args.root
    os.makedirs(root, exist_ok=True)

    # -- phase A: daemon subprocess, 3 wire submissions, drain ---------
    print("phase A: daemon subprocess, 3 wire jobs, drain")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "start", "--root", root,
         "--device", args.device, "--poll-interval", "0.02"])
    client = ServiceClient(root)
    try:
        deadline = time.time() + 120
        while (not client.daemon_alive() and proc.poll() is None
               and time.time() < deadline):
            time.sleep(0.1)
        _check(client.daemon_alive(), "daemon heartbeat appears")
        jobs = []
        for i in range(3):
            spec = JobSpec(f"smoke-{i}", workload="mlp",
                           workload_params={"size": "small", "seed": i},
                           iterations=2)
            jobs.append(client.submit(spec))
        client.drain()
        records = client.wait(jobs, timeout=300)
        _check(all(r.state is JobState.DONE for r in records.values()),
               "all 3 wire jobs ran to DONE "
               f"({ {j: r.state.value for j, r in records.items()} })")
        proc.wait(timeout=60)
        _check(proc.returncode == 0, "daemon exited cleanly after drain")
    finally:
        if proc.poll() is None:
            proc.kill()

    # -- phase B: simulated crash mid-run, restart, recover ------------
    # seed the SAME durable store as a crashed daemon would leave it:
    # one QUEUED, one ADMITTED, one RUNNING orphan
    print("phase B: crash recovery on the same root")
    now = time.time()
    store = JobStore(root)
    seeded = {"crash-q": JobState.QUEUED, "crash-a": JobState.ADMITTED,
              "crash-r": JobState.RUNNING}
    for jid, state in seeded.items():
        spec = JobSpec(jid, workload="mlp",
                       workload_params={"size": "small"}, iterations=1)
        store.put(JobRecord(spec=spec, state=state, submitted_at=now), now)
    daemon = _daemon(root, args.device, poll_interval=0.02)
    rec = daemon.recovered
    _check(set(rec["replayed"]) >= {"crash-q", "crash-a"},
           f"QUEUED/ADMITTED replayed ({sorted(rec['replayed'])})")
    _check(rec["requeued_orphans"] == ["crash-r"],
           "RUNNING orphan re-queued exactly once")
    _check(daemon.store.get("crash-r").requeues == 1,
           "orphan requeue recorded")
    ok = daemon.drain(timeout=300)
    _check(ok, "restarted daemon drained the recovered queue")
    states = {jid: daemon.store.get(jid).state for jid in seeded}
    _check(all(s is JobState.DONE for s in states.values()),
           f"recovered jobs ran to DONE ({ {j: s.value for j, s in states.items()} })")
    print("service smoke OK")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(prog="tensile-svc-torch",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start", help="run the daemon event loop")
    p.add_argument("--root", required=True)
    p.add_argument("--capacity-bytes", type=int, default=None)
    p.add_argument("--poll-interval", type=float, default=0.05)
    p.add_argument("--device", default="cuda",
                   help="torch device the daemon's jobs run on "
                        "(default: cuda; 'cpu' to opt in)")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("submit", help="submit a JobSpec over the inbox")
    p.add_argument("--root", required=True)
    p.add_argument("--job-id", required=True)
    p.add_argument("--kind", default="train", choices=("train", "serve"))
    p.add_argument("--workload", default=None,
                   help='registered name (e.g. "mlp", "lm") or '
                        '"module:attr"; required for train jobs')
    p.add_argument("--params", default="{}",
                   help="JSON dict of workload factory kwargs")
    p.add_argument("--arch", default="tinyllama-1.1b",
                   help="serve jobs: model config name")
    p.add_argument("--max-sequences", type=int, default=4,
                   help="serve jobs: batch slots in the decode cache")
    p.add_argument("--requests", type=int, default=8,
                   help="serve jobs: requests in the arrival trace")
    p.add_argument("--prompt-len", type=int, default=8)
    p.add_argument("--gen", type=int, default=8)
    p.add_argument("--trace", default="steady",
                   help="serve jobs: arrival trace (steady|burst|poisson)")
    p.add_argument("--block-tokens", type=int, default=4)
    p.add_argument("--iterations", type=int, default=1)
    p.add_argument("--priority", type=float, default=None)
    p.add_argument("--budget-hint-bytes", type=int, default=None)
    p.add_argument("--wait", action="store_true")
    p.add_argument("--timeout", type=float, default=300.0)
    p.set_defaults(fn=cmd_submit)

    p = sub.add_parser("status", help="daemon heartbeat + job table")
    p.add_argument("--root", required=True)
    p.add_argument("--json", action="store_true",
                   help="machine-readable heartbeat + full job records")
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("metrics",
                       help="print the daemon's Prometheus exposition")
    p.add_argument("--root", required=True)
    p.add_argument("--parsed", action="store_true",
                   help="print parsed samples instead of the raw text")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("drain", help="finish queued work, then stop")
    p.add_argument("--root", required=True)
    p.add_argument("--wait", action="store_true")
    p.add_argument("--timeout", type=float, default=300.0)
    p.set_defaults(fn=cmd_drain)

    p = sub.add_parser("smoke", help="CI end-to-end self-check")
    p.add_argument("--root", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device the daemons' jobs run on "
                        "(default: cuda; 'cpu' to opt in)")
    p.set_defaults(fn=cmd_smoke)

    args = ap.parse_args()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
