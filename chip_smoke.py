"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version at the serving path's shapes, measures
the pinned host link, then serves full-width TinyLlama-1.1B (bf16, seeded
random weights) twice through ``ServingEngine.serve``: unbudgeted (the
golden run) and under a KV budget of about two of four sequences with the
batched transfer path.  The budgeted run must reproduce the golden tokens
bit for bit, with no OOM, with evictions, and through both kernels.

Every phase raises on failure.  Without a CUDA card the script exits 1
and prints no result.  The last line of standard output is the JSON
device record; the line before it is the kernel table.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import MachineProfile, MemoryEngine  # noqa: E402
from repro_torch.kernels import kv_block_copy as kbc  # noqa: E402
from repro_torch.kernels.build import build_all  # noqa: E402
from repro_torch.kernels.ref import (kv_block_gather_ref,  # noqa: E402
                                     kv_block_scatter_ref)
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
import repro_torch.serving.engine as serving_engine  # noqa: E402
from repro_torch.serving import ServingEngine, make_trace  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
ARCH = "tinyllama-1.1b"
MAX_SEQUENCES, PROMPT_LEN, GEN_LEN, N_REQUESTS = 4, 16, 16, 8
MAX_LEN = PROMPT_LEN + GEN_LEN
SOURCE = "src/repro_torch/csrc/kv_block_copy.cu"
REPLACES = {"kv_block_gather": "src/repro/kernels/kv_block_copy.py:34",
            "kv_block_scatter": "src/repro/kernels/kv_block_copy.py:58"}


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
    from repro_torch.configs import get_config
    cfg = get_config(ARCH).reduced()
    cpu = TransformerLM(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    card = TransformerLM(cfg, device="meta")
    card.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                         assign=True)
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


def profile_decode(eng, steps: int = 4) -> dict:
    """Device time against host time over a few full-batch decode steps,
    from ``torch.profiler``: kernels per step, device-busy milliseconds and
    the device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile
    batch = {"tokens": torch.zeros((MAX_SEQUENCES, 1), dtype=torch.int32,
                                   device="cuda")}
    for i in range(2):
        eng._step(eng.params, eng.cache, batch, i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            eng._step(eng.params, eng.cache, batch, i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_kernels_per_step": len(kernels) / steps,
           "device_busy_ms_per_step": busy_ms / steps,
           "device_idle_share": (1 - busy_ms / wall_ms) if kernels else None,
           "top_kernels_ms": dict(by_name.most_common(5))}
    log("[profile] decode step (profiled, B=4): " + json.dumps(out))
    return out


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
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
