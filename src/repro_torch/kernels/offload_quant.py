"""Blocked int8 quantize-on-offload: the compressed swap path's kernels.

* ``quantize_blocked(x)``             -> ``(q, s, meta)``: q int8
  ``(R, 512)``, s fp32 ``(R, 1)``, meta ``(shape, dtype, pad)``
* ``dequantize_blocked(q, s, meta)``  -> x of the source shape and dtype

On a CUDA tensor both launch the hand-written kernels of
``csrc/offload_quant.cu`` (they replace the Pallas kernels
``quantize_blocked`` and ``dequantize_blocked`` of the JAX package's
``kernels/offload_quant.py``); on a CPU tensor they run the plain versions
of ``kernels/ref.py``.  Each wrapper counts its kernel launches in
``.launches``.  Inputs may be fp32, bf16 or fp16.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .ref import (QUANT_BLOCK, QuantMeta, dequantize_blocked_ref,
                  quantize_blocked_ref)

BLOCK = QUANT_BLOCK
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("offload_quant")
    lib.offload_quantize.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.offload_quantize.restype = ctypes.c_int
    lib.offload_dequantize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    lib.offload_dequantize.restype = ctypes.c_int
    lib.offload_quant_error_string.argtypes = [ctypes.c_int]
    lib.offload_quant_error_string.restype = ctypes.c_char_p
    return lib


def _check_err(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.offload_quant_error_string(err).decode())


def _check_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def quantize_blocked(x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, QuantMeta]:
    """Quantize ``x`` (any shape) in rows of 512 of its flattened elements;
    the last row's tail reads as zeros.  A non-contiguous ``x`` is copied
    to a contiguous one first."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"dtype {x.dtype} is not float32, bfloat16 or "
                        f"float16")
    _check_device(x)
    if x.device.type == "cpu":
        return quantize_blocked_ref(x)
    xc = x if x.is_contiguous() else x.contiguous()
    n = xc.numel()
    rows = math.ceil(n / BLOCK)
    q = torch.empty((rows, BLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    meta = (tuple(x.shape), x.dtype, rows * BLOCK - n)
    if n == 0:
        return q, s, meta
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.offload_quantize(
            xc.data_ptr(), DTYPE_CODES[x.dtype], n, q.data_ptr(),
            s.data_ptr(), rows,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_err(lib, err, "offload_quantize")
    quantize_blocked.launches += 1
    return q, s, meta


def dequantize_blocked(q: torch.Tensor, s: torch.Tensor, meta: QuantMeta,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q * s`` cast to the source dtype, in the source shape.  With
    ``out`` (contiguous, of that shape, dtype and device) the result is
    written there and ``out`` returned."""
    shape, dtype, pad = meta
    n = math.prod(shape)
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != BLOCK:
        raise ValueError(f"q must be int8 (R, {BLOCK}), got {q.dtype} "
                         f"{tuple(q.shape)}")
    if s.dtype != torch.float32 or tuple(s.shape) != (q.shape[0], 1):
        raise ValueError(f"s must be float32 ({q.shape[0]}, 1), got "
                         f"{s.dtype} {tuple(s.shape)}")
    if q.shape[0] * BLOCK - pad != n or not 0 <= pad < BLOCK:
        raise ValueError(f"meta {meta} does not match q {tuple(q.shape)}")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"dtype {dtype} is not float32, bfloat16 or float16")
    if s.device != q.device:
        raise ValueError("q and s must be on one device")
    _check_device(q)
    if out is not None and (tuple(out.shape) != tuple(shape)
                            or out.dtype != dtype or out.device != q.device
                            or not out.is_contiguous()):
        raise ValueError("out must be contiguous, of the source shape and "
                         "dtype, on q's device")
    if q.device.type == "cpu":
        x = dequantize_blocked_ref(q, s, meta)
        return x if out is None else out.copy_(x)
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError("q and s must be contiguous")
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=q.device)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.offload_dequantize(
            q.data_ptr(), s.data_ptr(), n, out.data_ptr(), DTYPE_CODES[dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _check_err(lib, err, "offload_dequantize")
    dequantize_blocked.launches += 1
    return out


quantize_blocked.launches = 0
dequantize_blocked.launches = 0
