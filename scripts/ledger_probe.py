"""Where the card's allocator and the executor's ledger part, operator by
operator, in ``chip_smoke.py``'s whisper TENSILE step.

    python3 scripts/ledger_probe.py [--budget 0.7]

Captures whisper-base's functional train step at full width (B 16 x 1500
frames, no remat), measures its operators once, plans it with ``tensile``
at ``--budget`` of its planned peak and runs the unscheduled and the
scheduled step on ``FxExecutor`` (async swaps) from the same state, as
``chip_smoke.py::whisper_tensile`` does.  For every operator it records
the allocator's bytes before the operator and its peak during it (host-side
bookkeeping: no synchronise needed), and the ledger's bytes before it
with the new storages the operator makes.  It prints, for each run, the
allocator's and the ledger's peaks, the operators where the allocator's
peak passes the ledger's by the most, and at the allocator's peak the
swap-outs still on the wire, by tensor kind.  The JSON goes to
``chiprun_out/ledger_probe.json``.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import FxExecutor  # noqa: E402

RUNS: dict = {}


def recording(base: int) -> None:
    """Wrap ``FxExecutor._eval_into`` to record each operator's bytes."""
    orig = FxExecutor._eval_into

    def hooked(self, node, idx):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated() - base
        ledger = self.accountant.job_bytes(self.ctx.job_id)
        out = orig(self, node, idx)
        peak = torch.cuda.max_memory_allocated() - base
        op = self.seq.operators[idx]
        new = sum(self.ctx.size_of(t) for t in op.outputs
                  if self._st(t) == t and t not in self.device)
        pending = collections.Counter()
        for st in self._pending_out:
            pending[self.seq.tensors[st].kind.value] += self.ctx.size_of(st)
        RUNS.setdefault(id(self), []).append({
            "op": idx, "name": op.name, "phase": op.phase.value,
            "allocated_before": before, "allocated_peak": peak,
            "ledger_before": ledger, "new_storages": new,
            "gap": peak - ledger - new, "pending_out": dict(pending)})
        return out

    FxExecutor._eval_into = hooked


def summary(recs: list, top: int) -> dict:
    at_peak = max(recs, key=lambda r: r["allocated_peak"])
    return {"operators": len(recs),
            "allocated_peak": at_peak["allocated_peak"],
            "ledger_peak_with_outputs": max(r["ledger_before"]
                                            + r["new_storages"]
                                            for r in recs),
            "at_allocated_peak": at_peak,
            "largest_gaps": sorted(recs, key=lambda r: -r["gap"])[:top]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=float, default=cs.WHISPER_BUDGET)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ledger_probe: no CUDA device", file=sys.stderr)
        return 1
    cs.deterministic()
    cs.log(cs.card_line())
    cs.WHISPER_BUDGET = args.budget
    link = cs.measure_host_link()
    torch.cuda.synchronize()
    recording(torch.cuda.memory_allocated())
    try:
        res = cs.whisper_tensile(link)
        cs.log("[ledger_probe] the whisper TENSILE gates held")
    except AssertionError as e:
        # the recorder resets the allocator's peak at every operator, so
        # the phase's own allocator gate reads only the last operator here
        res = None
        cs.log(f"[ledger_probe] whisper_tensile (its allocator gate reads "
               f"the recorder's last reset): {e}")
    # the runs in order: measured unscheduled, timed unscheduled, scheduled
    out = {"budget": args.budget, "tensile": res,
           "runs": [summary(r, args.top) for r in RUNS.values()]}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "ledger_probe.json"), "w") as f:
        json.dump(out, f, indent=1)
    for i, run in enumerate(out["runs"]):
        cs.log(f"[ledger_probe] run {i}: " + json.dumps(
            {k: run[k] for k in ("operators", "allocated_peak",
                                 "ledger_peak_with_outputs",
                                 "at_allocated_peak")}))
        for r in run["largest_gaps"]:
            cs.log(f"[ledger_probe]   gap {json.dumps(r)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
