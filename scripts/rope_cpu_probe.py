"""Does the CPU give the same reduced-whisper forward twice in a process?

    python3 scripts/rope_cpu_probe.py [--processes 16]

Runs the CPU forward of reduced fp32 whisper (``whisper-base`` reduced, B 2
x 160 frames, weights from seed 0, features from seed 1: the CPU reference
of ``chip_smoke.py::whisper_small_checks``) three times in each of
``--processes`` fresh processes, logging every floating-point aten op's
output, and compares the first forward with the second op by op and both
with the float64 forward.  One JSON line per process goes to standard
output; the last line sums them.  On the card's host (torch 2.11) some
processes' first forward returned wrong ``aten.cos`` values (ROADMAP §3).
Needs no card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))


def child() -> dict:
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.registry import get_model

    torch.use_deterministic_algorithms(True)
    cfg = get_config("whisper-base").reduced()
    api = get_model(cfg, "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    batch = api.input_specs(ShapeSpec("whisper_small", 160, 2, "train"),
                            abstract=False, seed=1)
    fwd = {k: v for k, v in batch.items() if k != "labels"}

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.outs = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else [out]):
                # the rope table is uploaded (and logged) on the first call
                # only: skip it so the logs line up
                if isinstance(o, torch.Tensor) and o.is_floating_point() \
                        and "lift_fresh" not in str(func) and o.dim() > 1:
                    self.outs.append((str(func), o.detach().clone()))
            return out

    step = build_prefill_step(api)
    logs, logits = [], []
    for _ in range(3):
        log = Log()
        with log:
            logits.append(step(params, fwd))
        logs.append(log.outs)
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    api64 = get_model(cfg64, "cpu")
    p64 = api64.shell()
    p64.load_state_dict({k: v.double() for k, v in
                         params.state_dict().items()}, assign=True)
    w64 = build_prefill_step(api64)(p64, {
        k: v.double() if v.is_floating_point() else v
        for k, v in fwd.items()})

    def gap(a, b) -> float:
        return float((a.double() - b.double()).abs().max())

    first = None
    for i, ((fa, ta), (_, tb)) in enumerate(zip(logs[0], logs[1])):
        if not torch.equal(ta, tb):
            first = {"index": i, "op": fa, "shape": list(ta.shape),
                     "max_abs_diff": gap(ta, tb)}
            break
    return {"torch": torch.__version__, "threads": torch.get_num_threads(),
            "ops": [len(lg) for lg in logs],
            "first_vs_second": gap(logits[0], logits[1]),
            "second_vs_third": gap(logits[1], logits[2]),
            "first_vs_float64": gap(logits[0], w64),
            "second_vs_float64": gap(logits[1], w64),
            "first_differing_op": first}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=16)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child()))
        return 0
    recs = []
    for _ in range(args.processes):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child"], capture_output=True, text=True,
                             timeout=600, check=True)
        recs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(recs[-1]), flush=True)
    drifted = [r for r in recs if r["first_vs_second"] > 0]
    print(json.dumps({
        "processes": len(recs), "first_forward_differs": len(drifted),
        "later_forwards_differ": sum(r["second_vs_third"] > 0
                                     for r in recs),
        "worst_first_vs_float64": max(r["first_vs_float64"] for r in recs),
        "worst_second_vs_float64": max(r["second_vs_float64"]
                                       for r in recs),
        "ops": sorted({r["first_differing_op"]["op"] for r in drifted})}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
