"""Readings that a cell's limits are set from, in one process on the card.

    python3 bench/calibrate.py --workload <cell> --seeds 12 [--control 3]
        [--first-seed N] [--out <dir>/<cell>.jsonl]

Set-up (capture, one measured unscheduled step, the plan) runs once; then
for each seed the program's checked steps under the plan (the window's
call, as ``bench/run.py`` drives it) and the reference's, and the numbers
compared (``harness.compare.gaps``).  For the first ``--control`` seeds it
also reads, against the same reference: the control, the reference put in
the program's place computing in fp8 what the program computes in bf16
(the precision below the configuration's), and the fault "half of the batch left out, the
mean taken over the rest", planted in the reference put in the program's
place.  (A step that returns its state unchanged reads 1 on the update by
construction and needs no run.)  Each side's numbers are judged against
the cell's limits (``harness.compare.judge``; the allocator's guarantee
needs a window and is left out): a sound program has to come out correct,
the control and the fault not.  Each reading is one JSON line; the last
line sums them up: per number, the largest program reading (the lower
reading of its limit) and the smallest of the control's and of the
fault's, and per side how many seeds came out correct.  No window is
timed.
"""
import argparse
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def readings(cell, device, seeds, control: int, first_seed: int,
             out=None):
    import torch
    from runners import train
    from harness import compare, weights
    job = None
    rows = []
    limits = {k: v for k, v in cell.cell["checks"].items()
              if k != cell.cell["guarantee"]["name"]}
    for n in range(seeds):
        seed = first_seed + 7919 * n
        if job is None:
            job = train.setup(cell, device, seed)
        job.seed = seed
        tr = cell.traffic
        job.batches = weights.make_batches(seed, tr["pool"], tr["batch"],
                                           tr["seq"],
                                           cell.config["vocab_size"], device)
        prog = train.checked_steps(job)
        job.state, job.host_inputs = None, set()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = train.reference_steps(cell, seed, device)
        row = {"seed": seed, "program": compare.gaps(prog, ref),
               "sides": {"program": prog, "reference": ref}}
        if n < control:
            ctl = train.reference_steps(cell, seed, device, fp8=True)
            half = train.reference_steps(cell, seed, device,
                                         half_batch=True)
            row["control"] = compare.gaps(ctl, ref)
            row["half_batch"] = compare.gaps(half, ref)
            row["sides"].update({"control": ctl, "half_batch": half})
        row["correct"] = {
            kind: all(c["ok"] for c in
                      compare.judge(row[kind], limits).values())
            for kind in ("program", "control", "half_batch") if kind in row}
        rows.append(row)
        if out is not None:
            print(json.dumps(row), file=out, flush=True)
    summary = {}
    for name in rows[0]["program"]:
        summary[name] = {
            "program_max": max(r["program"][name] for r in rows),
            "program_all": [r["program"][name] for r in rows]}
        for kind in ("control", "half_batch"):
            got = [r[kind][name] for r in rows if kind in r]
            if got:
                summary[name][kind + "_min"] = min(got)
                summary[name][kind + "_all"] = got
    summary["correct"] = {
        kind: [r["correct"][kind] for r in rows if kind in r["correct"]]
        for kind in ("program", "control", "half_batch")}
    return rows, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_019)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    import torch
    from harness.cells import load_cell
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cell = load_cell(a.workload)
    t0 = time.perf_counter()
    out = None
    if a.out:
        pathlib.Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        out = open(a.out, "w")
    try:
        _, summary = readings(cell, torch.device("cuda", 0), a.seeds,
                              a.control, a.first_seed,
                              out=out or sys.stdout)
    finally:
        if out is not None:
            out.close()
    summary["seconds"] = time.perf_counter() - t0
    summary["device"] = torch.cuda.get_device_name(0)
    print(json.dumps({"summary": summary, "workload": a.workload}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
