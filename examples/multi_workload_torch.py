"""Multiple dynamic workloads on one device, in the PyTorch port.

Three MLP train jobs of different shapes are submitted to one
``GlobalController``: it captures each graph at submission (cold-start
latencies from the cost model, no passive mode), plans over the merged
timeline, re-plans when measured latencies drift (EWMA, paper §IV-E), and
every job's swaps share the one channel (paper Fig. 3/4).  The port's
counterpart of ``examples/multi_workload.py``; it runs on the CUDA card by
default:

    PYTHONPATH=src python examples/multi_workload_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import (GlobalController, MachineProfile,  # noqa: E402
                              SchedulerConfig, format_bytes)
from repro_torch.service import JobSpec, make_mlp  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    profile = MachineProfile(host_link_bw=16e9, compute_flops=5e10,
                             mem_bw=1e10)
    gc = GlobalController(
        profile=profile, async_swap=True, device=args.device,
        scheduler_config=SchedulerConfig(update_threshold=0.25))

    shapes = [([128, 512, 512, 16], 32),      # job 0: wide
              ([256, 256, 256, 256, 8], 64),  # job 1: deep
              ([64, 1024, 4], 16)]            # job 2: squat
    for j, (sizes, batch) in enumerate(shapes):
        payload = make_mlp(sizes, batch, seed=j, device=gc.device)
        h = gc.submit(JobSpec(f"job{j}", iterations=3, payload=payload))
        print(f"launched {h.job_id}: {len(h.seq.operators)} ops, "
              f"{format_bytes(h.seq.total_tensor_bytes())} tensors")

    # a job thread's failure raises here with every job's traceback
    gc.wait(timeout=600)
    running = [f"{j}: {len(h.step_times)} of {h.iterations} iterations"
               + (f", at operator {h.executor.current_op_index}"
                  if h.executor is not None else "")
               for j, h in gc.jobs.items() if not h.done]
    if running:
        raise TimeoutError("jobs still running after 600 s: "
                           + "; ".join(running))
    print(f"\nall jobs done on {gc.device}; global device peak "
          f"{format_bytes(gc.global_peak_bytes)}; "
          f"{gc.replan_count} scheduler passes (incl. drift re-plans)")
    for j, h in gc.jobs.items():
        s = h.stats[-1]
        print(f"  {j}: peak {format_bytes(h.peak_bytes)}, "
              f"{s.swap_out_count} swap-outs/iter, "
              f"steps {[f'{t:.2f}s' for t in h.step_times]}")


if __name__ == "__main__":
    main()
