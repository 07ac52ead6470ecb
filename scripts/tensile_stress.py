"""Repeats full-width TENSILE steps on the card, each against the exact
(unscheduled) step, to catch an intermittent fault of the executor's copy
stream.

    python3 scripts/tensile_stress.py [--after-ssm] [--seconds 240]

With ``--after-ssm`` the Mamba-2 780M phases of ``chip_smoke.py`` run
first, in its order.  Then the TinyLlama-1.1B train step of
``chip_smoke.py::tensile_train`` (B 4, S 1024, no remat, deterministic
algorithms) is captured, timed once unscheduled (the exact step: its
outputs stay on the card) and planned: the compressed-first plan at the
tightest budget it reaches, the same plan's events uncompressed, and the
``tensile`` plan at that budget and at 0.55, 0.65 and 0.8 of the
unscheduled planned peak.  Rounds of one async run of each plan from a
fresh state follow until the time is up.  An uncompressed run must equal
the exact step bit for bit; a compressed one must stay finite.  Each
failure prints the leaves it hit; the last line counts runs and failures
per plan.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import (FxExecutor, MachineProfile,  # noqa: E402
                              MemoryEngine)


def ssm_phases() -> None:
    """``chip_smoke.py``'s Mamba-2 phases, in its order."""
    cs.check_ssd()
    ssm = cs.serve(MachineProfile(), cs.SSM_ARCH)
    cs.profile_decode(ssm["eng"])
    cs.check_decode_on_small_input(cs.SSM_ARCH)
    cs.prefill(ssm["eng"], cs.ss.ssd_intra_chunk_fwd, cs._mamba_mix,
               cs.SSM_PREFILL_REL_TOL)
    cs.check_forward_on_small_input(cs.SSM_ARCH, cs.ss.ssd_intra_chunk_fwd)
    cs.train(ssm["eng"])
    cs.check_train_step_on_small_input(cs.SSM_ARCH)
    cs.time_ssd()
    del ssm
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--after-ssm", action="store_true")
    ap.add_argument("--seconds", type=float, default=240.0)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("tensile_stress: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.time()

    def log(msg: str) -> None:
        print(f"[{time.time() - t0:7.1f} s] {msg}", flush=True)

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    log(cs.card_line())
    cs.build()
    link = cs.measure_host_link()
    if a.after_ssm:
        ssm_phases()
        log("Mamba-2 phases done")
    quant_bw = cs.time_quant(cs.QUANT_BIG, torch.float32, link)[
        "quantize_source_bytes_per_s"]

    cap = cs.tensile_capture(link, quant_bw)
    cfg, batch, seq, gm, names, profile, peak = (
        cap[k] for k in ("cfg", "batch", "seq", "gm", "names", "profile",
                         "unsched_peak"))
    n = len(names)
    ex = FxExecutor(gm, seq, None, engine=MemoryEngine(profile),
                    measure_latency=True)
    exact = ex.run_donated(cs._tensile_state(cfg, batch))
    seq.set_latencies(ex.stats.op_latencies)
    del ex
    torch.cuda.empty_cache()

    def leaf(i: int) -> str:
        for g, k in (("params", 0), ("mu", n + 1), ("nu", 2 * n + 1)):
            if k <= i < k + n:
                return f"{g} {names[i - k]}"
        return "step" if i == n else f"output {i}"

    res, _ = cs._plan(seq, profile, cs.COMPRESSED_FIRST,
                      int(cs.FLOOR_FRACTION * peak))
    budget = res.final_report.peak_bytes
    plans = {"compressed": res.plans[seq.job_id]}
    plans["compressed, uncompressed"] = cs._uncompressed(plans["compressed"])
    plans["tensile"] = cs._plan(seq, profile, "tensile",
                                budget)[0].plans[seq.job_id]
    for frac in (0.55, 0.65, 0.8):
        plans[f"tensile {frac}"] = cs._plan(
            seq, profile, "tensile", int(frac * peak))[0].plans[seq.job_id]
    for name, plan in plans.items():
        log(f"plan {name}: {json.dumps(cs._event_counts(seq, plan))}")

    runs, fails = collections.Counter(), collections.Counter()
    end = time.time() + a.seconds
    while time.time() < end:
        for name, plan in plans.items():
            torch.cuda.empty_cache()
            ex = FxExecutor(gm, seq, plan, async_swap=True,
                            engine=MemoryEngine(profile))
            outs = ex.run_donated(cs._tensile_state(cfg, batch))
            runs[name] += 1
            if name == "compressed":
                bad = [(leaf(i), int((~torch.isfinite(o)).sum()))
                       for i, o in enumerate(outs) if o.is_floating_point()
                       and not bool(torch.isfinite(o).all())]
            else:
                bad = [(leaf(i), cs.max_abs_err(o.cuda(), e))
                       for i, (o, e) in enumerate(zip(outs, exact))
                       if not torch.equal(o.cuda(), e)]
            if bad:
                fails[name] += 1
                log(f"FAIL {name}: {len(bad)} leaves, first {bad[:8]}")
            del ex, outs
    log("runs and failures per plan: " + json.dumps(
        {k: [runs[k], fails[k]] for k in plans}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
