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

Every phase raises on failure.  Without a CUDA card the script exits 1
and prints no result.  The last line of standard output is the JSON
device record; the line before it is the kernel table.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import MachineProfile, MemoryEngine  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import kv_block_copy as kbc  # noqa: E402
from repro_torch.kernels.build import build_all  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: E402
                                     kv_block_gather_ref,
                                     kv_block_scatter_ref)
from repro_torch.launch.steps import (TrainStepConfig,  # noqa: E402
                                     build_prefill_step, build_train_step,
                                     opt_state_for)
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.attention import attention_block  # noqa: E402
from repro_torch.models.layers import embed_tokens, rmsnorm  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
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
REPLACES = {"kv_block_gather": "src/repro/kernels/kv_block_copy.py:34",
            "kv_block_scatter": "src/repro/kernels/kv_block_copy.py:58",
            "flash_attention_fwd": "src/repro/kernels/flash_attention.py:77"}
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


def _spy(fn, name, shapes):
    def call(pool, idx, *rest):
        shapes[(name, tuple(pool.shape), str(pool.dtype), len(idx))] += 1
        return fn(pool, idx, *rest)
    return call


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
    build()

    link = measure_host_link()
    log("[host_link] " + json.dumps(link))

    width = 22 * MAX_LEN * 4 * 64          # one slot's row of a KV leaf
    serve_shapes = [(MAX_SEQUENCES, width, torch.bfloat16, k)
                    for k in (2, 3, 4)]
    worst = check_kernels(serve_shapes + [
        (MAX_SEQUENCES, width, torch.float32, 3),
        (7, 1001, torch.bfloat16, 3),        # 2-byte rows: element path
        (5, 333, torch.float32, 2),          # 4-byte rows
        (6, 77, torch.uint8, 4)])            # 1-byte rows
    check_decode_on_small_input()

    timings = {}
    for n, w, dtype, k in serve_shapes:
        timings[k] = time_kernels(n, w, dtype, k)
        log(f"[time] pool ({n}, {w}) {dtype} K={k}: "
            + json.dumps(timings[k]))

    profile = MachineProfile()
    result = serve(profile)
    profile_decode(result["eng"])
    flash_errs = check_flash()
    pre = prefill(result["eng"])
    check_forward_on_small_input()
    train(result["eng"])
    check_train_step_on_small_input()
    tf = time_flash()
    bud = result["runs"]["budgeted"]
    kernels = []
    for name in ("kv_block_gather", "kv_block_scatter"):
        ks = collections.Counter()
        for (kname, _, _, k), c in bud["shapes"].items():
            if kname == name:
                ks[k] += c
        k_main = ks.most_common(1)[0][0] if ks else 2
        t = timings.get(k_main, timings[2])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": bud["launches"][name],
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
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
