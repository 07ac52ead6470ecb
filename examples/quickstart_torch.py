"""Quickstart in the PyTorch port: TENSILE on one train step.

Capture the quickstart MLP's train step (the sizes and batch of
``examples/quickstart.py``: 256-1024-1024-1024-16, batch 64, tanh, mean
squared error, AdamW), let the Memory Scheduler plan swaps and
recomputation under a device-memory budget, execute the plan with
``FxExecutor``, and check that the outputs equal the unscheduled run's
and that the executed peak falls.  It runs on the CUDA card by default:

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core import (CostModel, DeviceCalibration,  # noqa: E402
                              FxExecutor, MachineProfile,
                              capture_train_step, evaluate, format_bytes,
                              schedule_single)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.service import make_mlp  # noqa: E402

SIZES = [256, 1024, 1024, 1024, 16]
BATCH = 64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ----- 1. the train step: weights and data from numpy seed 0 -------
    step, params, opt_state, batch = make_mlp(SIZES, BATCH, seed=0,
                                              device=device)

    # ----- 2. capture the graph -> Tensor Access Sequence ---------------
    # the quickstart's slow machine, in the profile and in the operator
    # latencies the capture prices, so that swaps can hide behind compute
    profile = MachineProfile(host_link_bw=16e9, compute_flops=5e10,
                             mem_bw=1e10)
    cost = CostModel(DeviceCalibration(flops=profile.compute_flops,
                                       mem_bw=profile.mem_bw))
    seq, gm = capture_train_step(step, params, opt_state, batch,
                                 cost_model=cost)
    print(f"captured: {len(seq.operators)} operators, "
          f"{len(seq.tensors)} tensors")

    # ----- 3. plan under a memory budget (Algorithms 1-3) ---------------
    result = schedule_single(seq, profile=profile)
    plan = result.plans[seq.job_id]
    print(f"plan: {result.swaps_scheduled} swaps, "
          f"{result.recomputes_scheduled} recomputes, "
          f"{sum(1 for e in plan.events if e.crosses_iteration)} "
          f"across-iteration events")
    print(f"predicted peak: "
          f"{format_bytes(result.initial_report.peak_bytes)} -> "
          f"{format_bytes(result.final_report.peak_bytes)} "
          f"(MSR {result.memory_saving_ratio:.2%})")

    # ----- 4. simulated cost/benefit (paper metrics) --------------------
    metrics = evaluate([seq], result.plans, profile)
    print(f"simulated: MSR={metrics['MSR']:.3f} EOR={metrics['EOR']:.3f} "
          f"CBR={metrics['CBR']:.2f}")

    # ----- 5. really execute the plan, and the unscheduled run ----------
    ex = FxExecutor(gm, seq, plan)
    out = ex.run(params, opt_state, batch)
    ex0 = FxExecutor(gm, seq, None)
    out0 = ex0.run(params, opt_state, batch)
    # a storage the plan parks on the host comes back as a host tensor
    ok = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(out, out0))
    fell = ex.stats.peak_bytes < ex0.stats.peak_bytes
    print(f"executed on {device}: outputs match the unscheduled run = {ok}; "
          f"real peak {format_bytes(ex0.stats.peak_bytes)} -> "
          f"{format_bytes(ex.stats.peak_bytes)} "
          f"({ex.stats.swap_out_count} swap-outs, "
          f"{ex.stats.swap_in_count} swap-ins)")
    ex.close(), ex0.close()
    if not (ok and fell):
        print("FAILED: the outputs differ or the peak did not fall")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
