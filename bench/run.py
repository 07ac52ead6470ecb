"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on this machine's first CUDA card and
prints, as the last line of standard output, one JSON object: whether the
checked output is correct, the steps attempted and failed, the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics (``--trace
1``, with the device's busy seconds and a breakdown from the profiler),
and the device; each compared number beside its limit comes last there
(``checks``) and in the last lines of standard error.  The run's record
(plan, budget, ledger and allocator peaks, measured EOR) is the line
before.  Everything a cell needs is found by its name: see
``harness/cells.py``.  Exits with 2 without a CUDA card (or with fewer
than the cell asks for), and with 3 if the JAX package or JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / "build" / "bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
THREADS = 4


def loaded_forbidden() -> list:
    """Modules loaded whose top-level name is one of FORBIDDEN, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch
    from harness.cells import load_cell, runner

    cell = load_cell(a.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.spec["chips"]:
        print(f"{a.workload} needs {cell.spec['chips']} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = runner(cell).run(cell, a.seed, a.seconds, bool(a.trace), T_START,
                           device)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    record = res.pop("record")
    checks = res.pop("checks")
    print(json.dumps({"record": record, "workload": a.workload,
                      "seed": a.seed}))
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})"
              f"{'' if c['ok'] else ' FAILED'}", file=sys.stderr)
    out = {k: res[k] for k in ("correct", "attempted", "failed", "metrics",
                               "device")}
    if "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
