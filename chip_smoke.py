"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives
its two paths at the full width of TinyLlama-1.1B (bf16, random weights
from seed 0):

1. serving: the KV gather/scatter kernel bit-exact against its plain
   version at the serving path's shapes, the pinned host link, the
   reduced decode card-vs-CPU, then ``ServingEngine.serve`` twice,
   unbudgeted (the golden run) and under a KV budget of about two of four
   sequences with the batched transfer path.  The budgeted run must
   reproduce the golden tokens bit for bit, with no OOM, with evictions,
   and through both kernels.
2. the LM forward and training: the flash-attention kernel against its
   plain version at the reference's sweep and at the prefill's shape; the
   prefill (B 4, S 2048) through ``build_prefill_step`` with the kernel,
   which must launch it once per layer and agree with the plain attention
   path; the reduced fp32 forward card-vs-CPU; 4 train steps (B 4,
   S 1024) through ``build_train_step``, whose loss must fall; the reduced
   fp32 train step card-vs-CPU; and the kernel's times.
3. TENSILE, the paper's own loop: the quantize/dequantize kernels
   bit-exact against their plain versions (``check_quant``); the
   quickstart MLP captured, planned and executed, its executor peak and
   decision trace equal to the simulator's (``tensile_mlp``); then the
   full-width train step (B 4, S 1024, no block remat) captured on fake
   tensors, its operator latencies measured by one unscheduled run, planned
   with the compressed pass first under the tightest budget that plan
   reaches, and executed for 3 iterations with swaps to pinned host memory
   on a copy stream (``tensile_train``).  The same budget's uncompressed
   ``tensile`` plan must give results bit-identical to the unscheduled
   run, the compressed plan results within stated tolerances, and the
   card's allocator peak must sit within 5 % of the executor's ledger
   peak and below the unscheduled run's.

Every phase raises on failure.  Without a CUDA card the script exits 1
and prints no result.  The last line of standard output is the JSON
device record; the line before it is the kernel table.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.utils._pytree as pytree

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import (CostModel, DeviceCalibration,  # noqa: E402
                              FxExecutor, MachineProfile, MemoryEngine,
                              MemoryScheduler, Pipeline, SchedulerConfig,
                              SchedulingPlan,
                              build_pipeline, calibrate_cuda,
                              capture_train_step, evaluate, schedule_single,
                              simulate)
from repro_torch.core.passes import (CompressedOffloadPass,  # noqa: E402
                                     RecomputePass, SwapPass)
import repro_torch.core.executor as tensile_executor  # noqa: E402
from repro_torch.core.graph_capture import graph_layout  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import kv_block_copy as kbc  # noqa: E402
from repro_torch.kernels import offload_quant as oq  # noqa: E402
from repro_torch.kernels.build import build_all  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: E402
                                     kv_block_gather_ref,
                                     dequantize_blocked_ref,
                                     kv_block_scatter_ref,
                                     quantize_blocked_ref)
from repro_torch.launch.steps import (TrainStepConfig,  # noqa: E402
                                     build_functional_train_step,
                                     build_prefill_step, build_train_step,
                                     opt_state_for)
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.attention import attention_block  # noqa: E402
from repro_torch.models.layers import embed_tokens, rmsnorm  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.optim.adam import adamw_init  # noqa: E402
from repro_torch.service.workloads import make_mlp, mlp_numpy  # noqa: E402
import repro_torch.serving.engine as serving_engine  # noqa: E402
from repro_torch.serving import ServingEngine, make_trace  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, same sheet
ARCH = "tinyllama-1.1b"
MAX_SEQUENCES, PROMPT_LEN, GEN_LEN, N_REQUESTS = 4, 16, 16, 8
MAX_LEN = PROMPT_LEN + GEN_LEN
PREFILL_B, PREFILL_S = 4, 2048          # the model's published context
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 4
SOURCE = "src/repro_torch/csrc/kv_block_copy.cu"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
QUANT_SOURCE = "src/repro_torch/csrc/offload_quant.cu"
REPLACES = {"kv_block_gather": "src/repro/kernels/kv_block_copy.py:34",
            "kv_block_scatter": "src/repro/kernels/kv_block_copy.py:58",
            "flash_attention_fwd": "src/repro/kernels/flash_attention.py:77",
            "quantize_blocked": "src/repro/kernels/offload_quant.py:43",
            "dequantize_blocked": "src/repro/kernels/offload_quant.py:60"}
# quantize/dequantize sweep: ragged lengths (one element, a row less one, a
# row and one, the reference's (37, 129)) in each input dtype, and 64 MiB
QUANT_SHAPES = [(1,), (511,), (513,), (37, 129)]
QUANT_BIG = (16 << 20,)
# the quickstart (examples/quickstart.py): its MLP, batch, planning profile
# and the capture-time cost model the reference uses by default
MLP_SIZES, MLP_BATCH = [256, 1024, 1024, 1024, 16], 64
QUICKSTART_PROFILE = MachineProfile(host_link_bw=16e9, compute_flops=5e10,
                                    mem_bw=1e10)
QUICKSTART_CALIB = DeviceCalibration(flops=5e10, mem_bw=1e10)
# the full-width TENSILE train step: the compressed plan is first planned
# against this fraction of the unscheduled planned peak, which it cannot
# reach; the budget is then the peak it reaches, the tightest it can hold
TENSILE_ITERS = 3
FLOOR_FRACTION = 0.5
# the compressed plan's pipeline: the three passes of
# ``tensile+compressed-offload`` with the compressed pass first.  In the
# named order the plain swap pass books the whole host link at this width
# (mostly optimizer state), and the compressed pass after it finds no
# channel time (PERF.md).  It plans within the iteration: across it, the
# plan compressed parameters and moments too and held no recompute
# (PERF.md); the ``tensile`` plan carries the across-iteration events
COMPRESSED_FIRST = "compressed-first"
# no early stop on stagnation: hundreds of small compressed swaps each move
# the peak by less than the stop's 0.05 % before the other passes run
PLAN_PATIENCE = SchedulerConfig().max_iterations
# the card's allocator peak against the executor's ledger peak
ALLOC_LEDGER_TOL = 0.05
# A compressed step against the unscheduled (exact) step from the same
# state.  Loss: |diff| / |value|.  Parameters and moments: per leaf, the
# compressed step's update new_c - old against the exact step's new_e -
# old, by direction (cosine) and by size (norm ratio), each as the median
# over the leaves whose exact update is not zero.  The int8 rounding of
# activations read again in the forward moves the first step's gradient
# by most of its norm through 22 random layers (||diff|| / ||exact||
# medians 0.73, 0.84, 0.91 for parameters, mu and nu on the H100;
# PERF.md), so the gate is on what such noise keeps and a fault loses: a
# skipped update reads cosine 0 and ratio 0, a sign-flipped one cosine -1,
# an update applied twice ratio 2.  The script checks that the skipped
# update fails.
COMPRESSED_TOL = {"loss": 5e-3, "cosine": 0.2, "ratio": (0.5, 2.0)}
# (B, Sq, Skv, H, KV, D, causal, dtype, window): the reference's sweep,
# tests/test_kernels.py:19-48
FLASH_SWEEP = [
    (2, 128, 128, 4, 2, 64, True, torch.float32, 0),
    (1, 200, 200, 8, 1, 32, True, torch.float32, 0),
    (2, 64, 256, 4, 4, 128, False, torch.float32, 0),
    (1, 384, 384, 6, 2, 112, True, torch.float32, 0),
    (2, 256, 256, 4, 2, 64, True, torch.bfloat16, 0),
    (1, 96, 96, 2, 2, 256, True, torch.float32, 0),
    (1, 256, 256, 4, 2, 64, True, torch.float32, 64),
]
# the prefill's attention: TinyLlama's 32 query and 4 kv heads of dim 64
FLASH_PREFILL = (PREFILL_B, PREFILL_S, PREFILL_S, 32, 4, 64, True,
                 torch.bfloat16, 0)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Flash vs plain (attend_full) prefill, as max |diff| / max |reference|;
# PERF.md gives the measurements behind each.  bf16 end to end: 22 layers
# of random weights amplify one-ulp differences of the attention output.
# bf16 per layer, both paths on the same hidden state: a few bf16 ulps
# (2^-8 of a value each).  fp32 end to end: summation order only.
PREFILL_REL_TOL = {"bf16": 0.5, "bf16_layer": 0.02, "fp32": 1e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


def events_ms(fn, reps: int, inner: int = 1) -> float:
    """Median over ``reps`` of CUDA-event time of ``inner`` back-to-back
    calls of ``fn``, per call, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time per call of ``fn``: every kernel and copy it
    issues, summed from a ``torch.profiler`` trace of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / reps / 1e3


def wall_s(fn, reps: int) -> float:
    """Median host-clock seconds of ``fn`` ending in a synchronise."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def build() -> None:
    t0 = time.perf_counter()
    built = build_all()
    log(f"[build] {len(built)} librar{'y' if len(built) == 1 else 'ies'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for b in built.values():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {b.name}: {line.strip()}")


def measure_host_link() -> dict:
    """Pinned host <-> device copies: rate at 256 MiB, latency of a
    512-byte copy (host clock, ending in a synchronise), and the added cost
    of each further small copy queued behind one synchronise."""
    dev = torch.device("cuda")
    n = 256 << 20
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(n, dtype=torch.uint8, device=dev)
    h2d = n / (events_ms(lambda: card.copy_(host, non_blocking=True), 5)
               * 1e-3)
    d2h = n / (events_ms(lambda: host.copy_(card, non_blocking=True), 5)
               * 1e-3)
    small_h = torch.empty(512, dtype=torch.uint8, pin_memory=True)
    small_d = torch.empty(512, dtype=torch.uint8, device=dev)
    lat_d2h = wall_s(lambda: small_h.copy_(small_d), 200)
    lat_h2d = wall_s(lambda: small_d.copy_(small_h), 200)
    members = 8
    hosts = [torch.empty(512, dtype=torch.uint8, pin_memory=True)
             for _ in range(members)]

    def queued():
        for h in hosts:
            h.copy_(small_d, non_blocking=True)

    def one():
        hosts[0].copy_(small_d, non_blocking=True)

    per_member = (wall_s(queued, 200) - wall_s(one, 200)) / (members - 1)
    del host, card
    return {"h2d_bytes_per_s": h2d, "d2h_bytes_per_s": d2h,
            "host_link_bw": min(h2d, d2h),
            "latency_h2d_s": lat_h2d, "latency_d2h_s": lat_d2h,
            "host_link_latency": max(lat_h2d, lat_d2h),
            "dma_batch_overhead": max(per_member, 0.0)}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check_kernels(shapes) -> float:
    """Bit-exact kernel vs plain version for every (N, W, dtype, K) in
    ``shapes``, including the rows a scatter must leave alone.  Returns
    the largest absolute difference seen (0.0 when all pass)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for n, w, dtype, k in shapes:
        pool = (torch.randn((n, w), generator=gen, device="cuda") * 100
                ).to(dtype)
        idx = torch.randperm(n, generator=gen, device="cuda")[:k].tolist()
        got = kbc.kv_block_gather(pool, idx)
        want = kv_block_gather_ref(pool, idx)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"gather differs at {(n, w, dtype, k)}")
        blocks = (torch.randn((k, w), generator=gen, device="cuda") * 100
                  ).to(dtype)
        mine = kbc.kv_block_scatter(pool.clone(), idx, blocks)
        plain = kv_block_scatter_ref(pool.clone(), idx, blocks)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(mine, plain))
        untouched = [i for i in range(n) if i not in idx]
        if not (torch.equal(mine, plain)
                and torch.equal(mine[untouched], pool[untouched])):
            raise AssertionError(f"scatter differs at {(n, w, dtype, k)}")
        back = kbc.kv_block_scatter(pool.clone(), idx,
                                    kbc.kv_block_gather(pool, idx))
        if not torch.equal(back, pool):
            raise AssertionError(f"round trip differs at {(n, w, dtype, k)}")
        log(f"[kernels] bit-exact: pool ({n}, {w}) {dtype} K={k}")
    return worst


def time_kernels(n: int, w: int, dtype, k: int) -> dict:
    """Times of both kernels, their plain versions and one PyTorch call
    each, at one shape: medians of CUDA-event times of 50 back-to-back
    calls, per call.  ``ms`` is the kernel alone (prepared device indices);
    ``wrapper_ms`` adds the wrapper's checks and index upload, as the engine
    calls it.  At these sizes the host's launch rate sets all of them, so
    ``device_ms`` and ``library_device_ms`` give the device's own time from
    a profiler trace."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    pool = torch.randn((n, w), generator=gen, device="cuda").to(dtype)
    rows = torch.randperm(n, generator=gen, device="cuda")[:k].tolist()
    idx = torch.tensor(rows, dtype=torch.int32, device="cuda")
    idx64 = idx.long()
    out = torch.empty((k, w), dtype=dtype, device="cuda")
    blocks = torch.randn((k, w), generator=gen, device="cuda").to(dtype)
    row_bytes = w * pool.element_size()
    bound = 2 * k * w * pool.element_size() / HBM_BYTES_PER_S * 1e3
    res = {}
    reps, inner = 20, 50
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)   # index_copy_ has no
    try:                                        # deterministic CUDA path
        lib_g = events_ms(lambda: torch.index_select(pool, 0, idx64), reps,
                          inner)
        lib_s = events_ms(lambda: pool.index_copy_(0, idx64, blocks), reps,
                          inner)
        lib_g_dev = device_ms(lambda: torch.index_select(pool, 0, idx64))
        lib_s_dev = device_ms(lambda: pool.index_copy_(0, idx64, blocks))
    finally:
        torch.use_deterministic_algorithms(det)
    res["kv_block_gather"] = {
        "ms": events_ms(lambda: kbc._launch(pool, idx, out, None, k,
                                            row_bytes), reps, inner),
        "wrapper_ms": events_ms(lambda: kbc.kv_block_gather(pool, rows),
                                reps, inner),
        "plain_ms": events_ms(lambda: kv_block_gather_ref(pool, rows), reps,
                              inner),
        "library_ms": lib_g, "bound_ms": bound,
        "device_ms": device_ms(lambda: kbc._launch(pool, idx, out, None, k,
                                                   row_bytes)),
        "library_device_ms": lib_g_dev}
    res["kv_block_scatter"] = {
        "ms": events_ms(lambda: kbc._launch(blocks, None, pool, idx, k,
                                            row_bytes), reps, inner),
        "wrapper_ms": events_ms(lambda: kbc.kv_block_scatter(pool, rows,
                                                             blocks),
                                reps, inner),
        "plain_ms": events_ms(lambda: kv_block_scatter_ref(pool, rows,
                                                           blocks),
                              reps, inner),
        "library_ms": lib_s, "bound_ms": bound,
        "device_ms": device_ms(lambda: kbc._launch(blocks, None, pool, idx, k,
                                                   row_bytes)),
        "library_device_ms": lib_s_dev}
    return res


def check_decode_on_small_input() -> None:
    """Reduced TinyLlama in fp32: the card's decode steps agree with the
    CPU's on the same weights, tokens and cache (atol = rtol = 1e-4, the
    port's CPU parity tolerance; matmuls run in full fp32, TF32 is off)."""
    cfg = get_config(ARCH).reduced()
    cpu, card = small_models(cfg)
    api_c, api_g = get_model(cfg, "cpu"), get_model(cfg, "cuda")
    cache_c, cache_g = api_c.init_cache(2, 8), api_g.init_cache(2, 8)
    tok = torch.Generator().manual_seed(1)
    for i in range(6):
        t = torch.randint(0, cfg.vocab_size, (2, 1), generator=tok)
        with torch.inference_mode():
            lc, _ = api_c.decode(cpu, {"tokens": t}, cache_c, i)
            lg, _ = api_g.decode(card, {"tokens": t.cuda()}, cache_g, i)
        if not torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4):
            raise AssertionError(
                f"decode step {i}: card and CPU differ by "
                f"{max_abs_err(lg.cpu(), lc)}")
    log("[check] reduced fp32 decode: card == CPU within 1e-4 over 6 steps")


def small_models(cfg):
    """Reduced weights from seed 0 on the CPU, and the same values on the
    card."""
    cpu = TransformerLM(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    card = TransformerLM(cfg, device="meta")
    card.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                         assign=True)
    return cpu, card


def serve(profile: MachineProfile) -> dict:
    t0 = time.perf_counter()
    eng = ServingEngine(ARCH, reduced=False, max_sequences=MAX_SEQUENCES,
                        max_len=MAX_LEN, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() * p.element_size()
                   for p in eng.params.parameters())
    log(f"[serve] {eng.cfg.name} {eng.cfg.dtype}: {eng.cfg.n_layers} layers,"
        f" d {eng.cfg.d_model}, params {n_params} B, bytes_per_token "
        f"{eng.bytes_per_token}, init {time.perf_counter() - t0:.2f} s")
    with torch.inference_mode():
        logits, _ = eng.api.decode(
            eng.params, {"tokens": torch.zeros((1, 1), dtype=torch.int32,
                                               device="cuda")},
            eng.api.init_cache(1, MAX_LEN), 0)
    if logits.shape != (1, 1, eng.cfg.padded_vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")

    step_ms = []
    plain_step = eng._step

    def timed_step(params, cache, batch, index):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plain_step(params, cache, batch, index)
        torch.cuda.synchronize()
        if batch["tokens"].shape[0] == MAX_SEQUENCES:
            step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    eng._step = timed_step
    reqs = make_trace("poisson", N_REQUESTS, seed=0, prompt_len=PROMPT_LEN,
                      gen_len=GEN_LEN)

    runs = {}
    for name in ("golden", "budgeted"):
        step_ms.clear()
        budget = (None if name == "golden"
                  else eng.bytes_per_token * (2 * MAX_LEN + 2))
        mem = MemoryEngine(profile=profile, capacity_bytes=budget,
                           trace=True)
        shapes = collections.Counter()
        if name == "budgeted":
            # the main path: counts from 0, shapes recorded as it calls
            kbc.kv_block_gather.launches = 0
            kbc.kv_block_scatter.launches = 0
            serving_engine.kv_block_gather = _spy(kbc.kv_block_gather,
                                                  "kv_block_gather", shapes)
            serving_engine.kv_block_scatter = _spy(kbc.kv_block_scatter,
                                                   "kv_block_scatter", shapes)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            rep, out = eng.serve(reqs, budget_bytes=budget,
                                 schedule=name == "budgeted",
                                 block_tokens=4, engine=mem,
                                 batch_transfers=name == "budgeted")
            torch.cuda.synchronize()
        finally:
            serving_engine.kv_block_gather = kbc.kv_block_gather
            serving_engine.kv_block_scatter = kbc.kv_block_scatter
        wall = time.perf_counter() - t
        launches = {"kv_block_gather": kbc.kv_block_gather.launches,
                    "kv_block_scatter": kbc.kv_block_scatter.launches}
        runs[name] = dict(
            report=rep, out=out, wall_s=wall, shapes=shapes,
            launches=launches, budget=budget,
            median_step_ms=statistics.median(step_ms),
            max_memory_allocated=torch.cuda.max_memory_allocated())
        log(f"[serve] {name}: budget {budget} B, wall {wall:.3f} s, "
            f"{rep.tokens_generated} tokens, "
            f"{rep.tokens_generated / wall:.1f} tok/s wall, median decode "
            f"step {statistics.median(step_ms):.3f} ms over "
            f"{len(step_ms)} steps, max_memory_allocated "
            f"{runs[name]['max_memory_allocated']} B, served {rep.served}, "
            f"oom_events {rep.oom_events}, evictions {rep.evictions}, "
            f"prefetches {rep.prefetches}, peak {rep.peak_bytes} B, "
            f"turns {rep.turns}, batched_transfers {rep.batched_transfers}")

    gold, bud = runs["golden"], runs["budgeted"]
    if gold["report"].served != N_REQUESTS or any(
            len(t) != GEN_LEN or not all(0 <= x < eng.cfg.vocab_size
                                         for x in t)
            for t in gold["out"].values()):
        raise AssertionError("golden run: wrong number or range of tokens")
    if bud["out"] != gold["out"]:
        raise AssertionError("budgeted tokens differ from the golden run")
    rep = bud["report"]
    if rep.oom_events != 0 or rep.evictions <= 0:
        raise AssertionError(f"budgeted run: oom_events {rep.oom_events}, "
                             f"evictions {rep.evictions}")
    if rep.peak_bytes > bud["budget"]:
        raise AssertionError(f"peak {rep.peak_bytes} > budget "
                             f"{bud['budget']}")
    for name, n in bud["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the serve path")
    log(f"[serve] budgeted tokens == golden tokens for all {N_REQUESTS} "
        f"requests; launches {bud['launches']}; "
        f"cohort sizes {dict(bud['shapes'])}")
    eng._step = plain_step
    return {"eng": eng, "runs": runs}


def profile_window(fn) -> dict:
    """Device-busy ms, the device's idle share and the five kernels with
    the most device time over one call of ``fn``, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    return {"wall_ms": wall_ms, "device_kernels": len(kernels),
            "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if kernels else None,
            "top_kernels_ms": dict(by_name.most_common(5))}


def profile_decode(eng, steps: int = 4) -> dict:
    """Device time against host time over a few full-batch decode steps,
    from ``torch.profiler``: kernels per step, device-busy milliseconds and
    the device's idle share of the window."""
    batch = {"tokens": torch.zeros((MAX_SEQUENCES, 1), dtype=torch.int32,
                                   device="cuda")}
    for i in range(2):
        eng._step(eng.params, eng.cache, batch, i)

    def run():
        for i in range(steps):
            eng._step(eng.params, eng.cache, batch, i)

    prof = profile_window(run)
    out = {"steps": steps, "wall_ms_per_step": prof["wall_ms"] / steps,
           "device_kernels_per_step": prof["device_kernels"] / steps,
           "device_busy_ms_per_step": prof["device_busy_ms"] / steps,
           "device_idle_share": prof["device_idle_share"],
           "top_kernels_ms": prof["top_kernels_ms"]}
    log("[profile] decode step (profiled, B=4): " + json.dumps(out))
    return out


def flash_inputs(shape, seed: int):
    b, sq, skv, h, kvh, d, _, dtype, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(dims):
        return torch.randn(dims, generator=gen, device="cuda").to(dtype)

    return draw((b, sq, h, d)), draw((b, skv, kvh, d)), draw((b, skv, kvh, d))


def check_flash() -> dict:
    """The flash kernel against ``flash_attention_ref`` on the card, at the
    reference's sweep and at the prefill's shape, within the reference's
    tolerances (2e-5 fp32, 2e-2 bf16, as ``allclose`` rtol = atol).
    Returns the largest absolute difference per shape."""
    errs = {}
    for shape in FLASH_SWEEP + [FLASH_PREFILL]:
        causal, dtype, window = shape[6], shape[7], shape[8]
        q, k, v = flash_inputs(shape, 0)
        with torch.inference_mode():
            got = fa.flash_attention_fwd(q, k, v, causal=causal,
                                         sliding_window=window)
            want = flash_attention_ref(q, k, v, causal=causal,
                                       sliding_window=window)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        tol = FLASH_TOL[dtype]
        errs[shape] = err
        log(f"[flash] {shape[:6]} causal={causal} {dtype} window={window}: "
            f"max_abs_err {err:.3e} (tol {tol})")
        if got.shape != want.shape or not torch.allclose(
                got.float(), want.float(), rtol=tol, atol=tol):
            raise AssertionError(f"flash kernel differs at {shape}: {err}")
        del q, k, v, got, want
    return errs


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs that the masks leave for these lengths."""
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return int(mask.sum())


def time_flash() -> dict:
    """Times at the prefill's attention shape: the kernel (CUDA events over
    back-to-back calls of the wrapper, and its device time from a profiler
    trace), its plain version, and ``scaled_dot_product_attention`` (the
    library yardstick, on its (B,H,S,D) layout with the kv heads expanded,
    prepared outside the timed call; never called by the port).  The bound
    counts the two products over the unmasked pairs at the bf16 peak
    against q, k, v and o read or written once at the HBM rate."""
    b, sq, skv, h, kvh, d, causal, dtype, window = FLASH_PREFILL
    q, k, v = flash_inputs(FLASH_PREFILL, 1)
    g = h // kvh
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    flops = 4 * b * h * d * attention_pairs(sq, skv, causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ops = flops / BF16_FLOPS_PER_S * 1e3
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    with torch.inference_mode():
        res = {
            "ms": events_ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                           causal=causal),
                            10, inner=5),
            "device_ms": device_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal=causal), reps=5),
            "plain_ms": events_ms(lambda: flash_attention_ref(
                q, k, v, causal=causal), 5),
            "library_ms": events_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal), 10),
        }
    res.update(flops=flops, bytes=nbytes, bound_ms=max(bound_ops,
                                                        bound_bytes),
               bound_by="operations" if bound_ops >= bound_bytes
               else "bytes", ops_bound_ms=bound_ops,
               bytes_bound_ms=bound_bytes)
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    log("[time] flash_attention_fwd " + json.dumps(
        {"shape": [b, sq, h, kvh, d, "bfloat16", "causal"], **res}))
    return res


def prefill(eng) -> dict:
    """Full-width prefill through ``build_prefill_step`` with the flash
    kernel: B x S tokens from numpy seed 0 on the serve phase's weights.
    Gates the logits' shape and finiteness, one kernel launch per layer per
    forward, and agreement with the same forward on the plain attention
    path (``attend_full``, since S <= 2 * attn_chunk)."""
    cfg = dataclasses.replace(eng.cfg, use_flash_kernel=True)
    step = build_prefill_step(get_model(cfg, "cuda"))
    plain_step = build_prefill_step(get_model(eng.cfg, "cuda"))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0      # the main path: counts from 0
    t0 = time.perf_counter()
    logits = step(eng.params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fa.flash_attention_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    want = (PREFILL_B, PREFILL_S, cfg.padded_vocab)
    if tuple(logits.shape) != want or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}, "
                             f"want {want} and finite")
    if launches != cfg.n_layers:
        raise AssertionError(f"{launches} flash launches in one forward, "
                             f"want {cfg.n_layers}")
    plain = plain_step(eng.params, batch)
    agree = {"bf16": rel_max_diff(logits, plain),
             "argmax_agreement": float((logits.argmax(-1)
                                        == plain.argmax(-1)).float().mean()),
             "bf16_layer": check_layers(eng.params, eng.cfg, batch["tokens"])}
    del logits, plain
    agree["fp32"] = prefill_fp32(eng, batch)
    log("[prefill] flash vs attend_full, max |diff| / max |ref|: "
        + json.dumps(agree))
    for key, tol in PREFILL_REL_TOL.items():
        if not agree[key] <= tol:
            raise AssertionError(f"flash and plain prefill differ ({key}): "
                                 f"{agree[key]} > {tol}")
    wall = wall_s(lambda: step(eng.params, batch), 3)
    plain_wall = wall_s(lambda: plain_step(eng.params, batch), 3)
    prof = profile_window(lambda: step(eng.params, batch))
    tokens_n = PREFILL_B * PREFILL_S
    out = {"launches": launches, "first_call_s": first_s,
           "wall_ms": wall * 1e3, "tokens_per_s": tokens_n / wall,
           "plain_wall_ms": plain_wall * 1e3,
           "plain_tokens_per_s": tokens_n / plain_wall,
           "max_memory_allocated": peak, "profile": prof, **agree}
    log(f"[prefill] B={PREFILL_B} S={PREFILL_S} bf16, flash kernel: "
        + json.dumps(out))
    return out


def rel_max_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def check_layers(params, cfg, tokens) -> float:
    """Each layer's attention block on the hidden state the flash forward
    feeds it, through the kernel and through ``attend_full``: the largest
    relative difference over the layers."""
    flash_cfg = dataclasses.replace(cfg, use_flash_kernel=True)
    worst = 0.0
    with torch.inference_mode():
        x = embed_tokens(params["embed"], tokens).to(getattr(torch,
                                                             cfg.dtype))
        b, s = x.shape[:2]
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b,
                                                                        s)
        aux = torch.zeros((), device=x.device)
        for r in range(cfg.n_repeats):
            rep = params["blocks"].at(r)
            for i, spec in enumerate(cfg.block):
                p = rep[f"layer{i}"]
                h = rmsnorm(x, p["ln1"], cfg.norm_eps)
                worst = max(worst, rel_max_diff(
                    attention_block(p["attn"], h, pos, cfg=flash_cfg),
                    attention_block(p["attn"], h, pos, cfg=cfg)))
                x, aux = transformer._apply_layer(p, spec, x, pos, flash_cfg,
                                                  aux)
    return worst


def prefill_fp32(eng, batch) -> float:
    """The full-width prefill in fp32 (the serve weights widened), flash
    kernel against ``attend_full``: the relative difference of the
    logits."""
    cfg = dataclasses.replace(eng.cfg, dtype="float32")
    params = TransformerLM(cfg, device="meta")
    params.load_state_dict({k: v.float() for k, v
                            in eng.params.state_dict().items()}, assign=True)
    flash = build_prefill_step(get_model(
        dataclasses.replace(cfg, use_flash_kernel=True), "cuda"))(params,
                                                                  batch)
    plain = build_prefill_step(get_model(cfg, "cuda"))(params, batch)
    out = rel_max_diff(flash, plain)
    del params, flash, plain
    torch.cuda.empty_cache()
    return out


def check_forward_on_small_input() -> None:
    """Reduced TinyLlama in fp32: the card's forward through the flash
    kernel agrees with the CPU's plain forward on the same weights and
    tokens at 5e-4 (the reference's tolerance for the kernel inside the
    model, tests/test_kernels.py:96-115)."""
    cfg = get_config(ARCH).reduced()
    cpu, card = small_models(cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 96), dtype=np.int32))
    want = build_prefill_step(get_model(cfg, "cpu"))(cpu, {"tokens": tokens})
    n0 = fa.flash_attention_fwd.launches
    got = build_prefill_step(get_model(
        dataclasses.replace(cfg, use_flash_kernel=True), "cuda"))(
            card, {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    if fa.flash_attention_fwd.launches - n0 != cfg.n_layers:
        raise AssertionError("the reduced forward did not launch the kernel")
    if not torch.allclose(got.cpu(), want, atol=5e-4, rtol=5e-4):
        raise AssertionError(f"reduced forward: card and CPU differ by "
                             f"{max_abs_err(got.cpu(), want)}")
    log(f"[check] reduced fp32 forward (flash kernel) == CPU within 5e-4; "
        f"max_abs_err {max_abs_err(got.cpu(), want):.3e}")


def train(eng) -> dict:
    """Full-width training through ``build_train_step`` with the reference
    defaults (AdamW lr 1e-4, weight decay 0.01, clip 1.0, block remat, the
    plain attention path) on the serve phase's weights, updated in place:
    TRAIN_STEPS steps on one fixed batch from ``input_specs`` (seed 0).
    Gates finite loss and grad norm and a loss that falls."""
    api = get_model(eng.cfg, "cuda")
    batch = api.input_specs(ShapeSpec("smoke_train", TRAIN_S, TRAIN_B,
                                      "train"), abstract=False, seed=0)
    step = build_train_step(api, TrainStepConfig())
    opt = opt_state_for(eng.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_ms = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        _, opt, metrics = step(eng.params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_ms)
    out = {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
           "median_step_ms": med,
           "tokens_per_s": TRAIN_B * TRAIN_S / (med * 1e-3),
           "max_memory_allocated": peak}
    log(f"[train] B={TRAIN_B} S={TRAIN_S} bf16, {TRAIN_STEPS} steps: "
        + json.dumps(out))
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"non-finite loss or grad norm: {out}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    del opt
    return out


def check_train_step_on_small_input() -> None:
    """Reduced TinyLlama in fp32 (2 layers): one train step on the card
    agrees with the CPU's on the same weights and batch: loss and grad norm
    at rtol 1e-4, new parameters at rtol 2e-2, atol 2e-4 (the port's CPU
    test against the reference, tests/test_torch_forward.py)."""
    cfg = get_config(ARCH).reduced(n_layers=2)
    cpu, card = small_models(cfg)
    shape = ShapeSpec("s", 32, 4, "train")
    api_c, api_g = get_model(cfg, "cpu"), get_model(cfg, "cuda")
    batch = api_c.input_specs(shape, abstract=False, seed=0)
    _, _, mc = build_train_step(api_c)(cpu, opt_state_for(cpu), batch)
    _, _, mg = build_train_step(api_g)(
        card, opt_state_for(card), {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    for key in ("loss", "grad_norm"):
        if not np.isclose(float(mg[key]), float(mc[key]), rtol=1e-4):
            raise AssertionError(f"reduced train step {key}: card "
                                 f"{float(mg[key])}, CPU {float(mc[key])}")
    want = cpu.state_dict()
    for k, t in card.state_dict().items():
        if not torch.allclose(t.cpu(), want[k], rtol=2e-2, atol=2e-4):
            raise AssertionError(f"reduced train step: {k} differs by "
                                 f"{max_abs_err(t.cpu(), want[k])}")
    log(f"[check] reduced fp32 train step: card == CPU (loss "
        f"{float(mg['loss']):.6f} vs {float(mc['loss']):.6f})")


# ----------------------------------------------------------------------
# TENSILE: quantize kernels, the quickstart MLP, the full-width train step
# ----------------------------------------------------------------------
def check_quant(cases=None) -> dict:
    """Both quantize kernels against their plain versions on the card:
    int8 rows, scales and meta bit-exact, dequantized values exact, for
    fp32, bf16 and fp16 inputs at ragged lengths and one 64 MiB fp32
    tensor (or at the ``(shape, dtype)`` pairs of ``cases``); fp32 round
    trips within the reference's bound (absmax/127 per element,
    tests/test_kernels.py:71-82).  Returns the largest kernel vs
    plain difference (0.0 when all pass) and the largest fp32 round-trip
    error over its bound."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, worst_rt = 0.0, 0.0
    if cases is None:
        cases = [(s, d) for d in (torch.float32, torch.bfloat16,
                                  torch.float16)
                 for s in QUANT_SHAPES] + [(QUANT_BIG, torch.float32)]
    for shape, dtype in cases:
        x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(dtype)
        q, s, meta = oq.quantize_blocked(x)
        qr, sr, mr = quantize_blocked_ref(x)
        xk = oq.dequantize_blocked(q, s, meta)
        xp = dequantize_blocked_ref(q, s, meta)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err(q, qr), max_abs_err(s, sr),
                    max_abs_err(xk, xp))
        same = {"q": torch.equal(q, qr), "s": torch.equal(s, sr),
                "meta": meta == mr, "dequantized": torch.equal(xk, xp)
                and xk.shape == x.shape}
        if not all(same.values()):
            raise AssertionError(f"quantize kernels differ at {shape} "
                                 f"{dtype}: {same}, max_abs_err {worst}")
        if dtype == torch.float32:
            bound = (float(x.abs().max()) / 127.0 + 1e-7) * 1.01
            err = max_abs_err(xk, x)
            worst_rt = max(worst_rt, err / bound)
            if err > bound:
                raise AssertionError(f"round trip at {shape}: {err} > "
                                     f"{bound}")
        log(f"[quant] bit-exact: {shape} {dtype}")
    return {"max_abs_err": worst, "round_trip_err_over_bound": worst_rt}


def time_quant(shape, dtype) -> dict:
    """Times of both wrappers (CUDA events over back-to-back calls, and the
    device time from a profiler trace) and of their plain versions at one
    shape, with the byte bound at 3.35 TB/s: quantize reads n * itemsize and
    writes n + 4 R bytes, dequantize the reverse."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q, s, meta = oq.quantize_blocked(x)
    n, rows = x.numel(), q.shape[0]
    moved = n * x.element_size() + n + 4 * rows
    res = {}
    for name, fn, plain in (
            ("quantize_blocked", lambda: oq.quantize_blocked(x),
             lambda: quantize_blocked_ref(x)),
            ("dequantize_blocked", lambda: oq.dequantize_blocked(q, s, meta),
             lambda: dequantize_blocked_ref(q, s, meta))):
        res[name] = {"ms": events_ms(fn, 10, inner=10),
                     "device_ms": device_ms(fn),
                     "plain_ms": events_ms(plain, 5, inner=2),
                     "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                     "bytes": moved, "shape": list(shape),
                     "dtype": str(dtype).replace("torch.", "")}
    res["quantize_source_bytes_per_s"] = (
        n * x.element_size() / (res["quantize_blocked"]["ms"] * 1e-3))
    log("[time] quant " + json.dumps(res))
    return res


def tensile_mlp() -> dict:
    """The quickstart on the card: the MLP (weights and data from numpy
    seed 0) captured, planned by ``schedule_single`` with the quickstart
    profile, and executed in sync mode.  Gates: the plan schedules events,
    the executor's ledger peak and decision trace equal the simulator's
    (sync transfers), and the outputs are bit-equal to the unscheduled
    executor's."""
    np_params, np_data = mlp_numpy(MLP_SIZES, MLP_BATCH, seed=0)
    step, params, opt, batch = make_mlp(MLP_SIZES, MLP_BATCH, params=np_params,
                                        data=np_data, device="cuda")
    seq, gm = capture_train_step(step, params, opt, batch,
                                 cost_model=CostModel(QUICKSTART_CALIB))
    res = schedule_single(seq, profile=QUICKSTART_PROFILE)
    plan = res.plans[seq.job_id]
    sim_eng = MemoryEngine(QUICKSTART_PROFILE, trace=True)
    sim = simulate([seq], {seq.job_id: plan}, QUICKSTART_PROFILE,
                   iterations=1, transfer_mode="sync", engine=sim_eng)
    ex_eng = MemoryEngine(QUICKSTART_PROFILE, trace=True)
    ex = FxExecutor(gm, seq, plan, engine=ex_eng)
    out = ex.run(params, opt, batch)
    ex0 = FxExecutor(gm, seq, None, engine=MemoryEngine(QUICKSTART_PROFILE))
    out0 = ex0.run(params, opt, batch)
    torch.cuda.synchronize()
    metrics = evaluate([seq], res.plans, QUICKSTART_PROFILE)
    info = {"operators": len(seq.operators), "tensors": len(seq.tensors),
            "swaps": res.swaps_scheduled,
            "recomputes": res.recomputes_scheduled,
            "events": len(plan.events),
            "predicted_peak": res.final_report.peak_bytes,
            "sim_peak": sim.peak_bytes, "executor_peak": ex.stats.peak_bytes,
            "unscheduled_peak": ex0.stats.peak_bytes,
            "trace_records": len(ex_eng.trace.keys()),
            "swap_outs": ex.stats.swap_out_count,
            "swap_ins": ex.stats.swap_in_count,
            "simulated_MSR": metrics["MSR"], "simulated_EOR": metrics["EOR"]}
    log("[tensile_mlp] " + json.dumps(info))
    if not plan.events:
        raise AssertionError("the quickstart plan schedules nothing")
    if ex.stats.peak_bytes != sim.peak_bytes:
        raise AssertionError(f"executor peak {ex.stats.peak_bytes} != "
                             f"simulated {sim.peak_bytes}")
    if ex_eng.trace.keys() != sim_eng.trace.keys():
        raise AssertionError("executor and simulator decision traces differ")
    # a storage the plan parks on the host comes back as a host tensor
    if not all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(out, out0)):
        raise AssertionError("scheduled MLP outputs differ from unscheduled")
    return info


def _tensile_state(cfg, batch) -> list:
    """A fresh full-width train state as a flat list of leaves in the
    step's argument order: parameters from a CUDA generator seeded 0, zero
    AdamW moments, the fixed batch.  Nothing else keeps a reference to the
    parameters, so the executor can free what the plan frees."""
    params = dict(TransformerLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0)).named_parameters())
    return pytree.tree_leaves([params, adamw_init(params), batch])


def _run_state(ex, state: list, base: int) -> tuple:
    """One executor iteration on the donated ``state``; returns the
    outputs, wall seconds, the allocator's peak over the run (reset before
    it) less ``base`` (what was allocated before the state existed), and
    the executor's ledger peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = ex.run_donated(state)
    wall = time.perf_counter() - t0
    return (outs, wall, torch.cuda.max_memory_allocated() - base,
            ex.stats.peak_bytes)


def _plan(seq, profile, name: str, budget: int):
    cfg = SchedulerConfig(memory_budget_bytes=budget,
                          patience_iters=PLAN_PATIENCE)
    if name == COMPRESSED_FIRST:
        pipeline = Pipeline([CompressedOffloadPass(), SwapPass(),
                             RecomputePass()], name=name, profile=profile,
                            config=cfg)
    else:
        pipeline = build_pipeline(name, profile, cfg)
    ms = MemoryScheduler(profile, cfg, pipeline=pipeline)
    ms.register_job(seq)
    t0 = time.perf_counter()
    res = ms.schedule()
    return res, time.perf_counter() - t0


def _uncompressed(plan):
    """``plan`` with every event's compressed flag cleared."""
    out = SchedulingPlan(plan.job_id)
    for e in plan.events:
        out.add(dataclasses.replace(e, compressed=False))
    out.release_after_op.update(plan.release_after_op)
    return out


def _channel_share(seq, plan) -> float:
    """The share of the iteration the plan books on the host link."""
    return sum(e.duration for e in plan.events if e.event_type.value in (
        "swap_out", "swap_in")) / seq.iteration_time


def _event_counts(seq, plan) -> dict:
    c = collections.Counter()
    for e in plan.events:
        c[e.event_type.value] += 1
        if e.crosses_iteration:
            c["across_iteration"] += 1
        if e.compressed:
            c[f"compressed_{e.event_type.value}_"
              f"{seq.tensors[e.tensor_id].kind.value}"] += 1
    return dict(c)


def _host_copy(outs) -> list:
    return [o.detach().to("cpu", copy=True) for o in outs]


def _update_diffs(outs, ref, old, groups) -> dict:
    """Per group of state leaf positions, for each leaf i, the update
    ``d_c = outs_i - old_i`` against the exact update ``d_e = ref_i -
    old_i`` (fp64 on the card, one leaf at a time): cosine (0 where
    ``d_c`` is zero), ``||d_c|| / ||d_e||`` and ``||d_c - d_e|| /
    ||d_e||``.  Returns each one's median over the leaves with a nonzero
    exact update, the worst leaf by cosine, the count of leaves without an
    exact update and the count of non-finite entries of ``outs``."""
    out = {}
    for name, idx in groups.items():
        cos, ratio, rel, bad = [], [], [], 0
        for i in idx:
            a = outs[i].to("cuda", torch.float64)
            o = old[i].to("cuda", torch.float64)
            d_e = ref[i].to("cuda", torch.float64) - o
            d_c = a - o
            bad += int((~torch.isfinite(a)).sum())
            n_e, n_c = float(d_e.norm()), float(d_c.norm())
            if n_e > 0:
                cos.append((float((d_c * d_e).sum()) / (n_c * n_e)
                            if n_c > 0 else 0.0, i))
                ratio.append(n_c / n_e)
                rel.append(float((d_c - d_e).norm()) / n_e)
        out[name] = {"cosine": statistics.median(c for c, _ in cos),
                     "ratio": statistics.median(ratio),
                     "rel_l2": statistics.median(rel),
                     "min_cosine": min(cos)[0], "worst_leaf": min(cos)[1],
                     "no_update": len(idx) - len(cos), "nonfinite": bad}
    return out


def _update_failures(diffs: dict) -> list:
    """What of ``diffs`` breaks COMPRESSED_TOL: a group with non-finite
    entries, a median cosine under its limit, a median ratio outside its
    band."""
    lo, hi = COMPRESSED_TOL["ratio"]
    fails = []
    for k, v in diffs.items():
        if v["nonfinite"]:
            fails.append(f"{k}: non-finite")
        if not v["cosine"] >= COMPRESSED_TOL["cosine"]:
            fails.append(f"{k}: cosine {v['cosine']} < "
                         f"{COMPRESSED_TOL['cosine']}")
        if not lo <= v["ratio"] <= hi:
            fails.append(f"{k}: ratio {v['ratio']} outside {lo}-{hi}")
    return fails


def _scheduled(gm, seq, plan, profile, cfg, batch, n_state: int, tag: str,
               check, base: int, exact: bool = False) -> tuple:
    """TENSILE_ITERS async iterations from a fresh state, the storages
    parked on the host at each iteration's end carried into the next as
    host-resident inputs.  ``check(k, outs, ref)`` returns extra fields for
    iteration k; with ``exact``, ``ref`` holds host copies of the
    unscheduled step's outputs from the same state (``outs``) and of that
    state (``old``), else it is None.  Returns the records, the final
    state and its host set."""
    torch.cuda.empty_cache()
    state = _tensile_state(cfg, batch)
    batch_leaves = pytree.tree_leaves(batch)
    host_inputs: set = set()
    recs = []
    for k in range(TENSILE_ITERS):
        ref = None
        if exact:
            ref = {"outs": _host_copy(FxExecutor(gm, seq, None, engine=(
                MemoryEngine(profile))).run(state)),
                "old": _host_copy(state[:n_state])}
            torch.cuda.empty_cache()
        ex = FxExecutor(gm, seq, plan, async_swap=True,
                        host_resident_inputs=host_inputs,
                        engine=MemoryEngine(profile))
        outs, wall, alloc, ledger = _run_state(ex, state, base)
        rec = {"iteration": k + 1, "wall_s": wall,
               "max_memory_allocated": alloc, "ledger_peak": ledger,
               "swap_outs": ex.stats.swap_out_count,
               "swap_ins": ex.stats.swap_in_count,
               "passive_swap_ins": ex.stats.passive_swap_ins,
               "recomputes": ex.stats.recompute_count,
               "compressed_swaps": ex.stats.compressed_swaps,
               "host_stall_s": ex.stats.stall_time_s,
               "transfer_launches": len(ex.async_exec.batches),
               "loss": float(outs[n_state]),
               "parked_at_end": len(ex.ending_host_storages())}
        rec.update(check(k, outs, ref))
        recs.append(rec)
        log(f"[tensile] {tag} " + json.dumps(rec))
        host_inputs = ex.ending_host_storages()
        state = outs[:n_state] + batch_leaves
        del ex, outs, ref
    return recs, state, host_inputs


def _forward_reads(gm, seq, plan, loss_pos: int) -> tuple:
    """The loss's operator and the plan's compressed swap-ins whose target
    operator comes at or before it (a forward operator), in target order,
    each with its tensor, the tensor's producer and its swap-out."""
    lay = graph_layout(gm)
    loss_tid = lay.tid[lay.owner[lay.out_leaves[loss_pos]]]
    loss_op = next(op.idx for op in seq.operators if loss_tid in op.outputs)
    producer = {t: op for op in seq.operators for t in op.outputs}
    outs = collections.defaultdict(list)
    for e in plan.events:
        if e.compressed and e.event_type.value == "swap_out":
            outs[e.tensor_id].append(e.trigger_op)
    reads = []
    for e in sorted((e for e in plan.events if e.compressed
                     and e.event_type.value == "swap_in"
                     and e.target_op is not None
                     and e.target_op <= loss_op),
                    key=lambda e: e.target_op):
        t, p = seq.tensors[e.tensor_id], producer.get(e.tensor_id)
        reads.append({
            "tensor": e.tensor_id, "kind": t.kind.value,
            "shape": list(t.shape), "dtype": t.dtype,
            "producer": f"{p.idx} {p.name}" if p else None,
            "swapped_out_after_op": max(
                (o for o in outs[e.tensor_id] if o < e.target_op),
                default=None),
            "read_by_op": f"{e.target_op} "
                          f"{seq.operators[e.target_op].name}"})
    return loss_op, reads


def tensile_train(link: dict, quant_bw: float) -> dict:
    """The paper's loop at full width: capture the train step on fake
    tensors, plan it under a budget, execute it (see the module
    docstring).  Returns what the kernel table and the report need."""
    cfg = dataclasses.replace(get_config(ARCH), remat="none")
    api = get_model(cfg, "cuda")
    batch = api.input_specs(ShapeSpec("tensile_train", TRAIN_S, TRAIN_B,
                                      "train"), abstract=False, seed=0)
    step = build_functional_train_step(api, TrainStepConfig())
    calib = calibrate_cuda()
    log(f"[tensile] calibrate_cuda: {calib.flops:.4e} flop/s, "
        f"{calib.mem_bw:.4e} B/s")
    params = dict(TransformerLM(cfg, device="meta").named_parameters())
    n_params, names = len(params), list(params)
    t0 = time.perf_counter()
    # traced on fake tensors: the arguments' shapes, dtypes and device only
    args = pytree.tree_map(lambda p: torch.empty_like(p, device="cuda"),
                           (params, adamw_init(params)))
    seq, gm = capture_train_step(step, *args, batch,
                                 cost_model=CostModel(calib))
    capture_s = time.perf_counter() - t0
    del params, args
    n_state = 1 + 3 * n_params                 # params, step, mu, nu
    groups = {"params": range(n_params),
              "mu": range(n_params + 1, 2 * n_params + 1),
              "nu": range(2 * n_params + 1, 3 * n_params + 1)}
    profile = MachineProfile(host_link_bw=link["host_link_bw"],
                             host_link_latency=link["host_link_latency"],
                             dma_batch_overhead=link["dma_batch_overhead"],
                             offload_quant_bw=quant_bw)
    unsched_peak = simulate([seq], None, profile, iterations=1,
                            transfer_mode="sync").peak_bytes
    log(f"[tensile] captured {len(seq.operators)} operators, "
        f"{len(seq.tensors)} tensors in {capture_s:.2f} s; unscheduled "
        f"planned peak {unsched_peak} B")

    # what the card holds before any train state exists (the allocator's
    # readings below are net of it)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    log(f"[tensile] allocated before the train state: {base} B")

    # ---- unscheduled: twice from the same state.  The first run times
    # each operator (synchronised), and its latencies replace the analytic
    # ones in the sequence, as the paper's runtime feeds measured latencies
    # back; the second run is the timed one ----------------------------
    unsched = []
    analytic_s = seq.iteration_time
    for measure in (True, False):
        torch.cuda.empty_cache()
        ex = FxExecutor(gm, seq, None, engine=MemoryEngine(profile),
                        measure_latency=measure)
        outs, wall, alloc, ledger = _run_state(
            ex, _tensile_state(cfg, batch), base)
        unsched.append({"wall_s": wall, "max_memory_allocated": alloc,
                        "ledger_peak": ledger})
        if measure:
            seq.set_latencies(ex.stats.op_latencies)
            ref1 = _host_copy(outs)
        del ex, outs
    log("[tensile] unscheduled: " + json.dumps(unsched))
    log(f"[tensile] iteration time: analytic {analytic_s:.4f} s, measured "
        f"per operator {seq.iteration_time:.4f} s")

    # ---- plan: the compressed plan against an unreachable budget; the
    # peak it reaches is the budget of every scheduled run --------------
    res_c, plan_s = _plan(seq, profile, COMPRESSED_FIRST,
                          int(FLOOR_FRACTION * unsched_peak))
    plan_c = res_c.plans[seq.job_id]
    budget = res_c.final_report.peak_bytes
    counts_c = _event_counts(seq, plan_c)
    log(f"[tensile] {COMPRESSED_FIRST} plan: {json.dumps(counts_c)}, "
        f"budget {budget} B ({budget / unsched_peak:.4f} of the unscheduled "
        f"planned peak), host link booked {_channel_share(seq, plan_c):.3f}"
        f" of the iteration, {res_c.iterations} planner iterations in "
        f"{plan_s:.2f} s")
    plans = {}
    for name in ("tensile+compressed-offload", "tensile"):
        res_n, plan_n_s = _plan(seq, profile, name, budget)
        plans[name] = (res_n, res_n.plans[seq.job_id])
        log(f"[tensile] {name} at the same budget: "
            f"{json.dumps(_event_counts(seq, plans[name][1]))}, predicted "
            f"peak {res_n.final_report.peak_bytes} B, host link booked "
            f"{_channel_share(seq, plans[name][1]):.3f} of the iteration, "
            f"{plan_n_s:.2f} s")
    res_t, plan_t = plans["tensile"]
    counts_t = _event_counts(seq, plan_t)
    missing = [f"{name}: {k}" for name, c, kinds in (
        ("compressed", counts_c, ("swap_out", "swap_in", "recompute")),
        ("tensile", counts_t, ("swap_out", "swap_in", "across_iteration")))
        for k in kinds if not c.get(k)]
    if not any(k.startswith("compressed") for k in counts_c):
        missing.append("compressed: compressed events")
    if missing:
        raise AssertionError(f"the plans lack {missing}")
    if res_c.final_report.peak_bytes > budget:
        raise AssertionError(f"predicted peak {res_c.final_report.peak_bytes}"
                             f" > budget {budget}")
    sim = {name: evaluate([seq], {seq.job_id: p}, profile, iterations=3)
           for name, p in (("compressed", plan_c), ("tensile", plan_t))}
    log("[tensile] simulated (3 iterations, vs no-free vanilla): "
        + json.dumps(sim))
    # what can change the first step's loss: compressed copies read again
    # before the loss is computed
    loss_op, fwd_reads = _forward_reads(gm, seq, plan_c, n_state)
    log(f"[tensile] loss computed by op {loss_op} "
        f"{seq.operators[loss_op].name}; {len(fwd_reads)} compressed "
        f"swap-ins read at or before it; the first: "
        f"{json.dumps(fwd_reads[:3])}")

    # ---- the uncompressed plan: every step bit-identical to the
    # unscheduled step from the same state --------------------------------
    def check_plain(k, outs, ref):
        same = all(torch.equal(a.cpu(), b) for a, b in zip(outs, ref["outs"]))
        if not same:
            raise AssertionError(f"the uncompressed tensile plan's step "
                                 f"{k + 1} differs from the unscheduled step")
        return {"bit_identical_to_unscheduled": True}

    if not all(torch.equal(a, b) for a, b in zip(ref1, _host_copy(
            FxExecutor(gm, seq, None, engine=MemoryEngine(profile)).run(
                _tensile_state(cfg, batch))))):
        raise AssertionError("two unscheduled runs differ")
    del ref1
    plain_recs, _, _ = _scheduled(gm, seq, plan_t, profile, cfg, batch,
                                  n_state, "tensile", check_plain, base,
                                  exact=True)

    # ---- the compressed plan: the main path, each step's update against
    # the unscheduled step's from the same state ---------------------------
    def check_comp(k, outs, ref):
        loss, loss_ref = float(outs[n_state]), float(ref["outs"][n_state])
        rec = {"loss_rel_diff": abs(loss - loss_ref) / abs(loss_ref),
               "loss_bit_identical": bool(torch.equal(
                   outs[n_state].cpu(), ref["outs"][n_state])),
               "update_vs_exact_step": _update_diffs(
                   outs, ref["outs"], ref["old"], groups)}
        for g, d in rec["update_vs_exact_step"].items():
            d["worst_leaf"] = names[d["worst_leaf"] - groups[g].start]
        if k == 0:
            # the gate must reject a skipped update (cosine 0, ratio 0)
            rec["skipped_update"] = _update_diffs(
                ref["old"], ref["outs"], ref["old"], groups)
            if not _update_failures(rec["skipped_update"]):
                raise AssertionError("the update check passes a skipped "
                                     "update")
            # the same events uncompressed on the copy stream, from the same
            # state, must give the unscheduled step bit for bit: a race of
            # the copy stream shows here, where int8 rounding cannot hide it
            exact = _host_copy(FxExecutor(
                gm, seq, _uncompressed(plan_c), async_swap=True,
                engine=MemoryEngine(profile)).run_donated(
                    _tensile_state(cfg, batch)))
            if not all(torch.equal(a, b) for a, b in zip(exact,
                                                          ref["outs"])):
                raise AssertionError("the compressed plan's events, "
                                     "uncompressed, differ from the "
                                     "unscheduled step")
            rec["uncompressed_events_bit_identical"] = True
        return rec

    shapes = collections.Counter()
    oq.quantize_blocked.launches = 0          # the main path: counts from 0
    oq.dequantize_blocked.launches = 0
    tensile_executor.quantize_blocked = _spy_quant(oq.quantize_blocked,
                                                   shapes)
    try:
        comp_recs, state, host_inputs = _scheduled(
            gm, seq, plan_c, profile, cfg, batch, n_state,
            "tensile+compressed-offload", check_comp, base, exact=True)
    finally:
        tensile_executor.quantize_blocked = oq.quantize_blocked
    launches = {"quantize_blocked": oq.quantize_blocked.launches,
                "dequantize_blocked": oq.dequantize_blocked.launches}
    log(f"[tensile] main-path launches {launches}; quantized shapes "
        f"{ {str(k): v for k, v in shapes.items()} }")

    # ---- one more compressed iteration under the profiler -------------
    ex = FxExecutor(gm, seq, plan_c, async_swap=True,
                    host_resident_inputs=host_inputs,
                    engine=MemoryEngine(profile))
    box = [state]
    del state
    prof = profile_window(lambda: box.append(ex.run_donated(box.pop())))
    del ex, box
    torch.cuda.empty_cache()

    comp_kinds = collections.Counter(
        seq.tensors[e.tensor_id].kind.value for e in plan_c.events
        if e.compressed and e.event_type.value == "swap_out")
    t_unsched = unsched[1]["wall_s"]
    t_sched = statistics.median(r["wall_s"] for r in comp_recs[1:])
    alloc_u = unsched[1]["max_memory_allocated"]
    alloc_s = max(r["max_memory_allocated"] for r in comp_recs)
    out = {
        "operators": len(seq.operators), "tensors": len(seq.tensors),
        "capture_s": capture_s, "budget": budget,
        "budget_fraction": budget / unsched_peak,
        "planned_unscheduled_peak": unsched_peak,
        "predicted_peak": res_c.final_report.peak_bytes,
        "tensile_predicted_peak": res_t.final_report.peak_bytes,
        "predicted_MSR": 1 - res_c.final_report.peak_bytes / unsched_peak,
        "measured_MSR": 1 - alloc_s / alloc_u,
        "simulated_EOR": sim["compressed"]["EOR"],
        "analytic_iteration_s": analytic_s,
        "measured_iteration_s": seq.iteration_time,
        "unscheduled_step_s": t_unsched, "scheduled_step_s": t_sched,
        "measured_EOR": t_sched / t_unsched - 1,
        "planning_s": plan_s, "planner_iterations": res_c.iterations,
        "plan_events": _event_counts(seq, plan_c),
        "compressed_swap_out_kinds": dict(comp_kinds),
        "loss_op": loss_op, "forward_compressed_reads": len(fwd_reads),
        "unscheduled": unsched, "tensile": plain_recs,
        "compressed": comp_recs, "launches": launches,
        "quantized_shapes": {str(k): v for k, v in shapes.items()},
        "profile": prof}
    log("[tensile_train] " + json.dumps(
        {k: v for k, v in out.items()
         if k not in ("tensile", "compressed")}))
    out["quantized_shapes_raw"] = dict(shapes)
    for r in comp_recs:
        gap = abs(r["max_memory_allocated"] / r["ledger_peak"] - 1)
        if gap > ALLOC_LEDGER_TOL:
            raise AssertionError(
                f"iteration {r['iteration']}: allocator peak "
                f"{r['max_memory_allocated']} B is {gap:.2%} off the ledger "
                f"peak {r['ledger_peak']} B")
        if r["max_memory_allocated"] >= alloc_u:
            raise AssertionError("the scheduled run's allocator peak is not "
                                 "below the unscheduled run's")
        fails = _update_failures(r["update_vs_exact_step"])
        if not r["loss_rel_diff"] <= COMPRESSED_TOL["loss"]:
            fails.append(f"loss: {r['loss_rel_diff']} > "
                         f"{COMPRESSED_TOL['loss']}")
        if fails:
            raise AssertionError(f"compressed plan, iteration "
                                 f"{r['iteration']}: {fails}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    return out


def _spy_quant(fn, shapes):
    def call(x):
        shapes[(tuple(x.shape), str(x.dtype).replace("torch.", ""))] += 1
        return fn(x)
    return call


def _spy(fn, name, shapes):
    def call(pool, idx, *rest):
        shapes[(name, tuple(pool.shape), str(pool.dtype), len(idx))] += 1
        return fn(pool, idx, *rest)
    return call


def timed(name: str, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {name} {time.perf_counter() - t0:.2f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # deterministic numerics, set before the first CUDA call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)

    log(card_line())
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    timed("build", build)

    link = timed("host_link", measure_host_link)
    log("[host_link] " + json.dumps(link))

    width = 22 * MAX_LEN * 4 * 64          # one slot's row of a KV leaf
    serve_shapes = [(MAX_SEQUENCES, width, torch.bfloat16, k)
                    for k in (2, 3, 4)]
    worst = timed("check_kernels", check_kernels, serve_shapes + [
        (MAX_SEQUENCES, width, torch.float32, 3),
        (7, 1001, torch.bfloat16, 3),        # 2-byte rows: element path
        (5, 333, torch.float32, 2),          # 4-byte rows
        (6, 77, torch.uint8, 4)])            # 1-byte rows
    timed("check_decode", check_decode_on_small_input)

    timings = {}
    for n, w, dtype, k in serve_shapes:
        timings[k] = time_kernels(n, w, dtype, k)
        log(f"[time] pool ({n}, {w}) {dtype} K={k}: "
            + json.dumps(timings[k]))

    result = timed("serve", serve, MachineProfile())
    timed("profile_decode", profile_decode, result["eng"])
    flash_errs = timed("check_flash", check_flash)
    pre = timed("prefill", prefill, result["eng"])
    timed("check_forward", check_forward_on_small_input)
    timed("train", train, result["eng"])
    timed("check_train_step", check_train_step_on_small_input)
    tf = timed("time_flash", time_flash)
    bud = result["runs"]["budgeted"]
    serve_launches = bud["launches"]
    serve_shapes_seen = bud["shapes"]
    del result, bud
    torch.cuda.empty_cache()

    quant = timed("check_quant", check_quant)
    quant_big = timed("time_quant", time_quant, QUANT_BIG, torch.float32)
    timed("tensile_mlp", tensile_mlp)
    tt = timed("tensile_train", tensile_train, link,
               quant_big["quantize_source_bytes_per_s"])
    # both kernels against their plain versions at every shape the main
    # path quantized
    quant_main = timed("check_quant_main_path", check_quant, [
        (shape, getattr(torch, dtype))
        for shape, dtype in tt["quantized_shapes_raw"]])
    # the kernels' times at the main path's most quantized shape
    (shape, dtype), _ = max(tt["quantized_shapes_raw"].items(),
                            key=lambda kv: (kv[1], math.prod(kv[0][0])))
    qt = timed("time_quant", time_quant, shape, getattr(torch, dtype))
    kernels = []
    for name in ("kv_block_gather", "kv_block_scatter"):
        ks = collections.Counter()
        for (kname, _, _, k), c in serve_shapes_seen.items():
            if kname == name:
                ks[k] += c
        k_main = ks.most_common(1)[0][0] if ks else 2
        t = timings.get(k_main, timings[2])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": serve_launches[name],
            "max_abs_err": worst,
            "ms": t[name]["ms"], "plain_ms": t[name]["plain_ms"],
            "bound_ms": t[name]["bound_ms"], "bound_by": "bytes",
            "library_ms": t[name]["library_ms"],
            "wrapper_ms": t[name]["wrapper_ms"],
            "device_ms": t[name]["device_ms"],
            "library_device_ms": t[name]["library_device_ms"],
            "shape": [MAX_SEQUENCES, width, "bfloat16", k_main]})
    b, sq, _, h, kvh, d, _, _, _ = FLASH_PREFILL
    kernels.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "source": FLASH_SOURCE, "replaces": REPLACES["flash_attention_fwd"],
        "launches": pre["launches"],
        "max_abs_err": flash_errs[FLASH_PREFILL],
        "ms": tf["ms"], "plain_ms": tf["plain_ms"],
        "bound_ms": tf["bound_ms"], "bound_by": tf["bound_by"],
        "library_ms": tf["library_ms"], "device_ms": tf["device_ms"],
        "tolerance": FLASH_TOL[torch.bfloat16],
        "shape": [b, sq, h, kvh, d, "bfloat16", "causal"]})
    for name in ("quantize_blocked", "dequantize_blocked"):
        kernels.append({
            "name": name, "route": "cuda", "source": QUANT_SOURCE,
            "replaces": REPLACES[name], "launches": tt["launches"][name],
            "max_abs_err": max(quant["max_abs_err"],
                               quant_main["max_abs_err"]),
            "ms": qt[name]["ms"], "plain_ms": qt[name]["plain_ms"],
            "bound_ms": qt[name]["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "device_ms": qt[name]["device_ms"],
            "shape": qt[name]["shape"], "dtype": qt[name]["dtype"],
            "ms_64mib_fp32": quant_big[name]["ms"],
            "bound_ms_64mib_fp32": quant_big[name]["bound_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
