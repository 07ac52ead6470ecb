"""The comparison that decides ``correct`` for a training cell.

Both sides give, for the first ``checked_steps`` steps from the same
weights on the same batches: each step's loss, each parameter leaf's first
gradient norm as the optimizer gets it (after clipping), and each leaf's
change after the last checked step.  The numbers:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap between the two gradient norms,
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger;
* ``update_gap``: the same for the change of the parameters, over the
  leaves whose reference gradient is at least ``MOVED`` of the median
  leaf's (a leaf with a gradient of round-off, as a key's bias under
  softmax, moves under Adam by round-off alone).

A cell's file names the numbers it compares, each with its limit and the
readings it was set from, and those it does not compare, with why; every
run records them all.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

MOVED = 1e-3


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
                leaves: List[str]) -> float:
    med = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in leaves)


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(float("inf"))
    g_ref = ref["grad_norms"]
    med = statistics.median(g_ref.values())
    moved = [k for k, v in g_ref.items() if v >= MOVED * med]
    if set(prog["grad_norms"]) != set(g_ref):
        raise ValueError("the two sides' leaves differ")
    return {"loss_gap": max(losses),
            "grad_gap": _worst_leaf(prog["grad_norms"], g_ref, list(g_ref)),
            "update_gap": _worst_leaf(prog["delta_norms"],
                                      ref["delta_norms"], moved)}


def judge(values: Dict[str, float], limits: Dict[str, dict]) -> dict:
    """``{name: {"value", "limit", "ok"}}`` for each limited number; a
    number that is not finite fails."""
    out = {}
    for name, lim in limits.items():
        v = values.get(name)
        ok = v is not None and v == v and v <= lim["limit"]
        out[name] = {"value": v, "limit": lim["limit"], "ok": bool(ok)}
    return out
