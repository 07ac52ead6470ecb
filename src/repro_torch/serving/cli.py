"""Serving CLI: thin wrapper over :class:`ServingEngine.serve`.

    PYTHONPATH=src python -m repro_torch.serving.cli --arch tinyllama-1.1b \\
        --requests 8 --trace burst --prompt-len 8 --gen 8 --budget-kb 24

Runs on the CUDA card unless ``--device cpu`` is given.  The model is the
reduced smoke variant unless ``--full-width`` is given.
"""
from __future__ import annotations

import argparse

from ..core.engine import MemoryEngine
from ..core.plan import MachineProfile
from .engine import ServingEngine
from .traces import TRACE_NAMES, make_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="continuous-batching LM serving")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-width", dest="reduced", action="store_false",
                    help="serve the configuration at its published widths")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to opt in)")
    ap.add_argument("--max-sequences", type=int, default=4,
                    help="batch slots in the shared decode cache")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--trace", default="burst", choices=TRACE_NAMES)
    ap.add_argument("--block-tokens", type=int, default=4)
    ap.add_argument("--budget-kb", type=int, default=0,
                    help="serving KV budget (KiB); 0 = unbudgeted")
    ap.add_argument("--no-schedule", action="store_true",
                    help="disable KV residency scheduling (baseline)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    eng = ServingEngine(args.arch, reduced=args.reduced,
                        max_sequences=args.max_sequences,
                        max_len=args.prompt_len + args.gen, seed=args.seed,
                        device=args.device)
    requests = make_trace(args.trace, args.requests, seed=args.seed,
                          prompt_len=args.prompt_len, gen_len=args.gen)
    budget = args.budget_kb * 1024 or None
    mem = MemoryEngine(profile=MachineProfile(), capacity_bytes=budget,
                       trace=True)
    report, outputs = eng.serve(requests, budget_bytes=budget,
                                schedule=not args.no_schedule,
                                block_tokens=args.block_tokens, engine=mem)
    print(f"[serve] arch={eng.cfg.name} device={eng.device} "
          f"requests={report.n_requests} served={report.served} "
          f"tokens={report.tokens_generated} "
          f"({report.tokens_per_s:.1f} tok/s virtual)")
    print(f"[serve] ttft p99={report.ttft_p99 * 1e3:.2f}ms "
          f"oom_events={report.oom_events} peak={report.peak_bytes}B "
          f"evictions={report.evictions} prefetches={report.prefetches} "
          f"stall={report.stall_time * 1e3:.2f}ms")
    print("[serve] sample generations (token ids):")
    for rid in sorted(outputs)[:2]:
        print(f"    {rid}: {outputs[rid][:16]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
