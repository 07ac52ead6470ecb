"""Compare dry-run records: the reference's against the port's.

    PYTHONPATH=src python tools/dryrun_table_torch.py --ref experiments/artifacts \\
        --port experiments/artifacts_torch [--parent DIR]

Reads the single-pod (16 x 16) JSON records that ``python -m
repro.launch.dryrun`` writes under ``experiments/artifacts/`` and that
``python -m repro_torch.launch.dryrun`` writes under
``experiments/artifacts_torch/`` (or ``--artifact-dir``), and prints one markdown row per architecture:
for each shape the per-device peak in GB (10^9 B) of the reference, of
the port at ``--parent`` (records written by an earlier commit of the
port, when given) and of the port, and the port's counted FLOPs over the
reference's.  Then the largest ratios of peak and FLOPs.  These are
counts of sharded programs, not device measurements.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load(directory: str) -> dict:
    """``{(arch, shape): record}`` of the single-pod records."""
    out = {}
    for path in glob.glob(os.path.join(directory, "*__pod1.json")):
        with open(path) as f:
            rec = json.load(f)
        out[(rec["arch"], rec["shape"])] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", required=True)
    ap.add_argument("--port", required=True)
    ap.add_argument("--parent", default=None)
    args = ap.parse_args(argv)
    ref, port = load(args.ref), load(args.port)
    parent = load(args.parent) if args.parent else {}

    def gb(recs, key):
        rec = recs.get(key)
        return f"{rec['per_device_peak_bytes'] / 1e9:.2f}" if rec else "-"

    head = "ref / parent / port GB, FLOPs x" if parent else \
        "ref / port GB, FLOPs x"
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("| --- |" + " --- |" * len(SHAPES))
    ratios = []
    for arch in sorted({a for a, _ in ref} | {a for a, _ in port}):
        cells = []
        for shape in SHAPES:
            key = (arch, shape)
            if key not in ref and key not in port:
                cells.append("")
                continue
            parts = [gb(ref, key)] + ([gb(parent, key)] if parent else []) \
                + [gb(port, key)]
            flops = ""
            if key in ref and key in port:
                r, p = ref[key], port[key]
                fx = p["cost"]["flops"] / r["cost"]["flops"]
                px = p["per_device_peak_bytes"] / r["per_device_peak_bytes"]
                flops = f", {fx:.2f}x"
                ratios.append((px, fx, arch, shape))
            cells.append(" / ".join(parts) + flops)
        print(f"| {arch} | " + " | ".join(cells) + " |")
    print(f"\n({head})")
    if ratios:
        px = max(ratios)
        fx = max(ratios, key=lambda r: r[1])
        print(f"largest peak ratio {px[0]:.3f} ({px[2]} {px[3]}); largest "
              f"FLOPs ratio {fx[1]:.3f} ({fx[2]} {fx[3]}); "
              f"{len(ratios)} cells in both")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
