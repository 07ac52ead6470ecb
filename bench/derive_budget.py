"""Derives a cell's plan bytes once, on the card, and writes them into the
cell's file (``bench/workloads/<cell>.json``, ``plan``); runs read them.

    python3 bench/derive_budget.py --workload <cell> [--seed N]
        [--out <dir>]

The step is captured as ``bench/run.py`` captures it, and its unscheduled
planned peak is the simulator's with synchronous transfers
(``simulate(..., transfer_mode="sync")``).  The batch rule: the cell's
batch stands if that peak is at most ``BATCH_RULE`` of the card's
memory, else the script stops and says so.  Then the operators'
latencies are measured (``runners.train.measure``) and written, each
key's median, as the cell's latency table (``bench/latencies/<cell>.json``,
which every run plans from), and the planner is asked, with the table's
latencies, for ``share`` of that peak, the share being the cell's file's
``plan.derivation.share``:

``asked_bytes``, what every run's plan is asked for, is ``share`` of the
peak.  Rule ``budget``: the predicted peak of the plan it returns is the
budget, ``executor_budget_bytes``, which the executor holds the job to.
Rule ``floor``: the script checks that the predicted peak stays above the
asked bytes, so that the planner stops at the least peak it plans.

The derivation (peak, share, predicted peak, batch rule, the card, its
power limit) is written beside the bytes.
"""
import argparse
import json
import pathlib
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

BATCH_RULE = 0.9


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


def derive(cell, device, seed: int) -> dict:
    import torch
    from runners import train
    from repro_torch.core import simulate
    plan = cell.cell["plan"]
    share = plan["derivation"]["share"]
    job = train.prepare(cell, device, seed)
    peak = simulate([job.seq], None, job.profile, iterations=1,
                    transfer_mode="sync").peak_bytes
    card = job.profile.device_memory_bytes
    d = {"share": share, "unscheduled_planned_peak_bytes": peak,
         "batch": cell.traffic["batch"], "seq": cell.traffic["seq"],
         "batch_rule": f"{peak} B <= {BATCH_RULE} x {card} B: "
                       f"{peak <= BATCH_RULE * card}",
         "operators": job.rec["operators"],
         "capture_s": job.rec["capture_s"],
         "card": (torch.cuda.get_device_name(device)
                  if device.type == "cuda" else str(device)),
         "nvidia_smi": power_limit(), "torch": torch.__version__,
         "seed": seed}
    if peak > BATCH_RULE * card:
        return d, None
    table = train.latency_table(job.seq, train.measure(job))
    train.set_latencies(job, table)
    res = train.make_plan(job, int(share * peak), plan["pipeline"],
                          plan["patience_iters"])
    predicted = res.final_report.peak_bytes
    d.update({"predicted_peak_bytes": predicted,
              "predicted_share": predicted / peak,
              "plan_s": job.rec["plan_s"],
              "planner_iterations": res.iterations,
              "plan_events": job.rec["plan_events"],
              "unscheduled_allocator_peak_bytes":
                  job.rec["unscheduled_peak_bytes"],
              "unscheduled_ledger_bytes": job.rec["unscheduled_ledger_bytes"],
              "iteration_time_s": job.rec["iteration_time_s"]})
    plan["asked_bytes"] = int(share * peak)
    d["above_asked"] = predicted > plan["asked_bytes"]
    if plan["rule"] == "budget":
        plan["executor_budget_bytes"] = predicted
    plan["derivation"] = d
    return d, {"seconds": table, "operators": len(job.seq.operators),
               "card": d["card"], "nvidia_smi": d["nvidia_smi"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seed", type=int, default=1_000_003)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    import torch
    from harness.cells import BENCH as B, load_cell
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    for name in a.workload:
        cell = load_cell(name)
        d, table = derive(cell, torch.device("cuda", 0), a.seed)
        files = {"workloads": json.dumps(cell.cell, indent=2) + "\n"}
        if table is not None:
            files["latencies"] = json.dumps(table, indent=0) + "\n"
        for sub, text in files.items():
            for root in [B] + ([pathlib.Path(a.out)] if a.out else []):
                (root / sub).mkdir(parents=True, exist_ok=True)
                (root / sub / f"{name}.json").write_text(text)
        print(json.dumps({"workload": name, "derivation": d}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
