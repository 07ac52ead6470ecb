"""Host time per call of the quantize wrappers, split into its parts.

    python3 scripts/quant_host_time.py [--src DIR] [--calls 1000]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
the same script measures another tree's wrappers, such as a parent commit
unpacked beside this one.  Needs one CUDA card.  Deterministic algorithms
are on, as in ``chip_smoke.py``.

At the TENSILE main path's most quantized shape, (4, 1024, 32) fp32, it
times ``--calls`` calls of each wrapper as that tree's executor calls it
on a compressed swap (``time.perf_counter_ns``, the mean per call): the
whole wrapper call, and each of its parts made alone as many times:
allocation (the tensors the wrapper allocates), stream lookup (as the
wrapper reads the stream, its device context included) and the ctypes
call (the C entry with the same arguments); ``checks`` is the rest, the
whole call less those parts.  It also times the host allocations the
executor makes around one compressed swap-out (two pinned buffers for q
and s before, one packed buffer now, also through the executor's own
helper where the tree has it) and the pinned buffer of a plain 64 MiB
swap-out, each with the deterministic fill of new memory on and off.
Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (4, 1024, 32)


def per_call_us(fn, calls: int) -> float:
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return t / calls / 1e3


def split(total: float, parts: dict) -> dict:
    out = {"total_us": total, **{f"{k}_us": v for k, v in parts.items()}}
    out["checks_us"] = total - sum(parts.values())
    return out


def pinned_alloc_us(nbytes: int, fill: bool, calls: int) -> float:
    import torch
    det = torch.utils.deterministic

    def alloc():
        prev = det.fill_uninitialized_memory
        det.fill_uninitialized_memory = fill
        try:
            torch.empty(nbytes, dtype=torch.int8, pin_memory=True)
        finally:
            det.fill_uninitialized_memory = prev
    return per_call_us(alloc, calls)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--calls", type=int, default=1000)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.src))
    import torch
    from repro_torch.kernels import offload_quant as oq
    if not torch.cuda.is_available():
        print("quant_host_time: no CUDA device", file=sys.stderr)
        return 1
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.randn(SHAPE, device=dev)
    n = x.numel()
    rows = -(-n // oq.BLOCK)
    dst = torch.empty_like(x)
    lib = oq._lib()
    packed = hasattr(oq, "packed_bytes")
    calls = a.calls
    res = {"src": os.path.abspath(a.src), "shape": list(SHAPE),
           "dtype": "float32", "calls": calls,
           "interface": "packed" if packed else "staged"}
    if packed:
        # the executor's call: rows and scales into a packed pinned buffer,
        # read back from it; the raw stream, no device context
        buf = torch.empty(oq.packed_bytes(n), dtype=torch.int8,
                          pin_memory=True)
        qh, sh, meta = oq.quantize_blocked(x, out=buf)
        idx = dev.index

        def stream():
            return torch._C._cuda_getCurrentRawStream(idx)
        s0 = stream()
        res["quantize"] = split(
            per_call_us(lambda: oq.quantize_blocked(x, out=buf), calls),
            {"allocation": 0.0, "stream": per_call_us(stream, calls),
             "ctypes": per_call_us(lambda: lib.offload_quantize(
                 x.data_ptr(), 0, n, qh.data_ptr(), sh.data_ptr(), rows, 1,
                 0, s0), calls)})
        res["dequantize"] = split(
            per_call_us(lambda: oq.dequantize_blocked(qh, sh, meta, out=dst),
                        calls),
            {"allocation": 0.0, "stream": per_call_us(stream, calls),
             "ctypes": per_call_us(lambda: lib.offload_dequantize(
                 qh.data_ptr(), sh.data_ptr(), n, dst.data_ptr(), 0, 1, 0,
                 s0), calls)})
        # the executor's allocation of a packed buffer (no fill)
        from repro_torch.core.executor import empty_unfilled
        res["executor_packed_allocation_us"] = per_call_us(
            lambda: empty_unfilled((oq.packed_bytes(n),), (1,), torch.int8,
                                   pin=True), calls)
    else:
        # the executor's call: rows and scales on the card (then copied to
        # the host), dequantized from the card into its destination
        q, s, meta = oq.quantize_blocked(x)

        def stream():
            with torch.cuda.device(dev):
                return torch.cuda.current_stream(dev).cuda_stream

        def alloc():
            torch.empty((rows, oq.BLOCK), dtype=torch.int8, device=dev)
            torch.empty((rows, 1), dtype=torch.float32, device=dev)
        s0 = stream()
        res["quantize"] = split(
            per_call_us(lambda: oq.quantize_blocked(x), calls),
            {"allocation": per_call_us(alloc, calls),
             "stream": per_call_us(stream, calls),
             "ctypes": per_call_us(lambda: lib.offload_quantize(
                 x.data_ptr(), 0, n, q.data_ptr(), s.data_ptr(), rows, s0),
                 calls)})
        res["dequantize"] = split(
            per_call_us(lambda: oq.dequantize_blocked(q, s, meta, out=dst),
                        calls),
            {"allocation": 0.0, "stream": per_call_us(stream, calls),
             "ctypes": per_call_us(lambda: lib.offload_dequantize(
                 q.data_ptr(), s.data_ptr(), n, dst.data_ptr(), 0, s0),
                 calls)})
    # the executor's pinned allocations, the deterministic fill on and off
    big = 64 << 20
    res["pinned_allocation_us"] = {
        f"{what}_fill_{'on' if fill else 'off'}": pinned_alloc_us(
            nbytes, fill, calls if nbytes < big else 100)
        for what, nbytes in (("q", rows * oq.BLOCK), ("s", 4 * rows),
                             ("packed", rows * (oq.BLOCK + 4)),
                             ("plain_64mib", big))
        for fill in (True, False)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
