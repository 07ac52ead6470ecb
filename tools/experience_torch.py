"""Inspect and maintain the PyTorch port's on-disk experience store
(``src/repro_torch/core/experience.py``).

    PYTHONPATH=src python tools/experience_torch.py list   --dir <store>
    PYTHONPATH=src python tools/experience_torch.py show   --dir <store> \
        --fingerprint <prefix>
    PYTHONPATH=src python tools/experience_torch.py prune  --dir <store> \
        [--min-samples N] [--max-age-days D]
    PYTHONPATH=src python tools/experience_torch.py export --dir <store> \
        --out bundle.json
    PYTHONPATH=src python tools/experience_torch.py import --dir <store> \
        --bundle bundle.json

``list`` prints one row per fingerprint (samples, iterations, stall share,
measured peak, cached plans with the best certified peak, drift samples,
last update), then the device record.  ``show`` prints every record of
the entries whose fingerprint starts with the prefix, as JSON lines.
``prune`` drops stale or low-sample entries.  ``export``/``import`` move a
store between machines of the same device class as one JSON bundle
(imports merge under the store's monotonic-sample rules, so an older
bundle never regresses a newer store).  ``--device`` is the identity the
store's device record is keyed by (``device_identity`` of the controller's
profile); the fingerprint files do not depend on it.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core.experience import (ExperienceStore,  # noqa: E402
                                         _records_of)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GiB"


def _fmt_when(ts: float) -> str:
    if ts <= 0:
        return "-"
    return datetime.datetime.fromtimestamp(ts).strftime("%Y-%m-%d %H:%M")


def cmd_list(store: ExperienceStore, args: argparse.Namespace) -> int:
    rows = []
    for fp, entry in store.entries():
        ts = entry.telemetry
        plans = sorted(entry.plans.values(), key=lambda r: r.peak_bytes)
        rows.append((
            fp[:12],
            str(ts.samples if ts else 0),
            str(ts.iterations if ts else 0),
            f"{ts.stall_share:.3f}" if ts else "-",
            _fmt_bytes(ts.peak_bytes) if ts else "-",
            str(len(plans)),
            (f"{plans[0].pipeline}@{plans[0].bucket}:"
             f"{_fmt_bytes(plans[0].peak_bytes)}" if plans else "-"),
            str(len(entry.drift)),
            _fmt_when(entry.updated_at)))
    header = ("fingerprint", "samples", "iters", "stall", "peak", "plans",
              "best plan", "drift", "updated")
    widths = [max([len(h)] + [len(r[i]) for r in rows])
              for i, h in enumerate(header)]

    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths))

    print(line(header))
    print(line(["-" * w for w in widths]))
    for r in rows:
        print(line(r))
    dev = store.device_record()
    if dev is not None and dev.calibration is not None:
        c = dev.calibration
        print(f"\ndevice calibration: flops={c.flops:.4g} "
              f"mem_bw={c.mem_bw:.4g} overhead_s={c.overhead_s:.3g} "
              f"(samples={c.samples}, updated {_fmt_when(c.updated_at)})")
    for compressed in (False, True):
        bw = store.bandwidth(compressed=compressed)
        if bw:
            path = "compressed" if compressed else "full"
            print(f"device DMA bandwidth ({path}): {_fmt_bytes(bw)}/s")
    if not rows:
        print(f"\n(no entries under {store.dir})")
    return 0


def cmd_show(store: ExperienceStore, args: argparse.Namespace) -> int:
    fps = [fp for fp in store.fingerprints()
           if fp.startswith(args.fingerprint)]
    if not fps:
        print(f"no fingerprint starts with {args.fingerprint!r}",
              file=sys.stderr)
        return 1
    for fp in fps:
        entry = store.get(fp)
        if entry is None:
            continue
        for rec in _records_of(entry):
            print(json.dumps(rec, sort_keys=True))
    return 0


def cmd_prune(store: ExperienceStore, args: argparse.Namespace) -> int:
    dropped = store.prune(min_samples=args.min_samples,
                          max_age_days=args.max_age_days)
    for fp in dropped:
        print(f"pruned {fp[:12]}")
    print(f"{len(dropped)} entries pruned, "
          f"{len(store.fingerprints())} kept")
    return 0


def cmd_export(store: ExperienceStore, args: argparse.Namespace) -> int:
    bundle = store.export_bundle()
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(bundle, f, indent=1, sort_keys=True)
    print(f"exported {len(bundle['entries'])} entries to {args.out}")
    return 0


def cmd_import(store: ExperienceStore, args: argparse.Namespace) -> int:
    with open(args.bundle, "r", encoding="utf-8") as f:
        bundle = json.load(f)
    n = store.import_bundle(bundle)
    if n == 0 and bundle.get("schema") != store.SCHEMA:
        print(f"schema mismatch: bundle v{bundle.get('schema')} vs "
              f"store v{store.SCHEMA}; nothing imported")
        return 1
    print(f"imported {n} entries into {store.dir}")
    return 0


COMMANDS = {"list": cmd_list, "show": cmd_show, "prune": cmd_prune,
            "export": cmd_export, "import": cmd_import}


def main(argv=None) -> int:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--dir", required=True,
                        help="store root (the directory holding v<N>/)")
    common.add_argument("--device", default="default",
                        help="device identity the store is keyed by")
    ap = argparse.ArgumentParser(
        description="inspect and maintain a TENSILE experience store")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", parents=[common],
                   help="per-fingerprint summary table")
    p_show = sub.add_parser("show", parents=[common],
                            help="the records of one fingerprint")
    p_show.add_argument("--fingerprint", required=True,
                        help="a fingerprint or a prefix of one")
    p_prune = sub.add_parser("prune", parents=[common],
                             help="drop stale or low-sample entries")
    p_prune.add_argument("--min-samples", type=int, default=1,
                         help="drop entries with fewer op samples")
    p_prune.add_argument("--max-age-days", type=float, default=None,
                         help="drop entries older than this many days")
    p_exp = sub.add_parser("export", parents=[common],
                           help="write the store as one bundle")
    p_exp.add_argument("--out", required=True)
    p_imp = sub.add_parser("import", parents=[common],
                           help="merge a bundle into the store")
    p_imp.add_argument("--bundle", required=True)
    args = ap.parse_args(argv)
    store = ExperienceStore(args.dir, device_id=args.device)
    return COMMANDS[args.cmd](store, args)


if __name__ == "__main__":
    sys.exit(main())
