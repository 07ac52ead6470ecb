"""Blocked int8 quantize-on-offload: the compressed swap path's kernels.

* ``quantize_blocked(x, out=None)``  -> ``(q, s, meta)``: q int8
  ``(R, 512)``, s fp32 ``(R, 1)``, meta ``(shape, dtype, pad)``
* ``dequantize_blocked(q, s, meta, out=None)`` -> x of the source shape
  and dtype

On a CUDA tensor both launch the hand-written kernels of
``csrc/offload_quant.cu`` (they replace the Pallas kernels
``quantize_blocked`` and ``dequantize_blocked`` of the JAX package's
``kernels/offload_quant.py``); on CPU tensors they run the plain versions
of ``kernels/ref.py``.  Each wrapper call is one launch, counted in
``.launches``.  Inputs may be fp32, bf16 or fp16.

The packed buffer.  With ``out``, a 1-D int8 buffer of
``packed_bytes(numel)`` bytes, ``quantize_blocked`` writes the int8 rows
and then the scales into it and returns ``q`` and ``s`` as views of it
(``packed_views``).  From a card, ``out`` must be pinned host memory: the
kernel writes it through its device mapping, so a compressed swap-out is
one launch and no copy.  ``dequantize_blocked`` reads ``q`` and ``s`` from
the card, or from pinned host memory into an ``out`` on the card (one
launch, no copy).  A host operand that is not pinned is refused; nothing
is copied behind the caller's back.  A kernel's reads and writes of pinned
memory are invisible to PyTorch's caching host allocator, so the caller
keeps such a buffer alive until the launch has completed
(``core/executor.py`` does).
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
# what a launch returns when a host operand is not pinned memory
NOT_PINNED = -1


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("offload_quant")
    lib.offload_quantize.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.offload_quantize.restype = ctypes.c_int
    lib.offload_dequantize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.offload_dequantize.restype = ctypes.c_int
    lib.offload_quant_mapped_pointer.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.offload_quant_mapped_pointer.restype = ctypes.c_int
    lib.offload_quant_host_ctas.argtypes = [ctypes.c_int]
    lib.offload_quant_host_ctas.restype = ctypes.c_int
    lib.offload_quant_error_string.argtypes = [ctypes.c_int]
    lib.offload_quant_error_string.restype = ctypes.c_char_p
    _check_mapping(lib)
    return lib


def _check_mapping(lib: ctypes.CDLL) -> None:
    """The kernels take a pinned tensor's ``data_ptr`` as its device
    address: true when PyTorch's pinned blocks are mapped at their host
    address (unified addressing).  Checked once, on one pinned block."""
    probe = torch.empty(BLOCK, dtype=torch.int8, pin_memory=True)
    dev = ctypes.c_void_p()
    _check_err(lib, lib.offload_quant_mapped_pointer(probe.data_ptr(),
                                                     ctypes.byref(dev)),
               "cudaHostGetDevicePointer")
    if dev.value != probe.data_ptr():
        raise RuntimeError(f"pinned host memory at {probe.data_ptr():#x} is "
                           f"mapped at {dev.value or 0:#x}, not at its host "
                           "address")


def _check_err(lib, err: int, what: str) -> None:
    if err != 0:
        msg = f"{what} failed: " + lib.offload_quant_error_string(err).decode()
        raise (ValueError if err == NOT_PINNED else RuntimeError)(msg)


def _card(t: torch.Tensor) -> int:
    """The index of ``t``'s card, which must be the current device (the
    launch goes to the current device's context)."""
    dev = t.get_device()
    if dev != torch._C._cuda_getDevice():
        raise ValueError(f"{t.device} is not the current device")
    return dev


def packed_bytes(numel: int) -> int:
    """Bytes of the packed buffer of ``numel`` elements: R rows of 512
    int8, then R fp32 scales (R = ceil(numel / 512))."""
    return -(-numel // BLOCK) * (BLOCK + 4)


def packed_views(buf: torch.Tensor, rows: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, s)`` as views of a packed buffer of ``rows`` rows."""
    return (buf.as_strided((rows, BLOCK), (BLOCK, 1)),
            buf.view(torch.float32).as_strided((rows, 1), (1, 1),
                                                rows * BLOCK // 4))


def quantize_blocked(x: torch.Tensor, out: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, QuantMeta]:
    """Quantize ``x`` (any shape) in rows of 512 of its flattened elements;
    the last row's tail reads as zeros.  With ``out`` (a 1-D, contiguous,
    16-byte aligned int8 buffer of ``packed_bytes(x.numel())`` bytes on the
    host, pinned when ``x`` is on a card) the rows and scales are written
    there and returned as its views.  A non-contiguous ``x`` is copied to a
    contiguous one first."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"dtype {x.dtype} is not float32, bfloat16 or "
                        f"float16")
    card = x.is_cuda
    if not (card or x.is_cpu):
        raise ValueError(f"unsupported device {x.device}")
    n = x.numel()
    rows = -(-n // BLOCK)
    meta = (tuple(x.shape), x.dtype, rows * BLOCK - n)
    if out is not None:
        if (out.dtype != torch.int8 or out.dim() != 1
                or out.numel() != rows * (BLOCK + 4) or not out.is_cpu
                or not out.is_contiguous() or out.data_ptr() % 16):
            raise ValueError(f"out must be a contiguous, 16-byte aligned "
                             f"int8 host buffer of {rows * (BLOCK + 4)} "
                             f"bytes, got {out.dtype} {tuple(out.shape)} on "
                             f"{out.device}")
        q, s = packed_views(out, rows)
    if not card:
        qr, sr, _ = quantize_blocked_ref(x)
        if out is None:
            return qr, sr, meta
        q.copy_(qr)
        s.copy_(sr)
        return q, s, meta
    dev = _card(x)
    xc = x if x.is_contiguous() else x.contiguous()
    if out is None:
        q = torch.empty((rows, BLOCK), dtype=torch.int8, device=x.device)
        s = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if n == 0:
        return q, s, meta
    lib = _lib()
    err = lib.offload_quantize(
        xc.data_ptr(), DTYPE_CODES[x.dtype], n, q.data_ptr(), s.data_ptr(),
        rows, out is not None, 0, torch._C._cuda_getCurrentRawStream(dev))
    _check_err(lib, err, "offload_quantize launch")
    quantize_blocked.launches += 1
    return q, s, meta


def dequantize_blocked(q: torch.Tensor, s: torch.Tensor, meta: QuantMeta,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q * s`` cast to the source dtype, in the source shape, computed on
    ``out``'s device (``q``'s when ``out`` is None).  With ``out``
    (contiguous, of that shape and dtype) the result is written there and
    ``out`` returned.  On a card, ``q`` and ``s`` lie on that card or in
    pinned host memory (the kernel reads them over the link); ``q`` must
    be 16-byte aligned."""
    shape, dtype, pad = meta
    n = math.prod(shape)
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != BLOCK:
        raise ValueError(f"q must be int8 (R, {BLOCK}), got {q.dtype} "
                         f"{tuple(q.shape)}")
    if s.dtype != torch.float32 or s.shape != (q.shape[0], 1):
        raise ValueError(f"s must be float32 ({q.shape[0]}, 1), got "
                         f"{s.dtype} {tuple(s.shape)}")
    if q.shape[0] * BLOCK - pad != n or not 0 <= pad < BLOCK:
        raise ValueError(f"meta {meta} does not match q {tuple(q.shape)}")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"dtype {dtype} is not float32, bfloat16 or float16")
    host = q.is_cpu
    if s.is_cpu != host or not (host or s.device == q.device):
        raise ValueError("q and s must be on one device")
    if out is not None and (out.shape != shape or out.dtype != dtype
                            or not out.is_contiguous()):
        raise ValueError("out must be contiguous, of the source shape and "
                         "dtype")
    if (q if out is None else out).is_cpu:
        if not host:
            raise ValueError("a CPU out takes q and s from the host")
        x = dequantize_blocked_ref(q, s, meta)
        return x if out is None else out.copy_(x)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=q.device)
    if not out.is_cuda:
        raise ValueError(f"unsupported device {out.device}")
    if not (host or q.device == out.device):
        raise ValueError("q and s must lie on out's card or in pinned host "
                         "memory")
    if not (q.is_contiguous() and s.is_contiguous()) or q.data_ptr() % 16:
        raise ValueError("q and s must be contiguous, q 16-byte aligned")
    dev = _card(out)
    if n == 0:
        return out
    lib = _lib()
    err = lib.offload_dequantize(
        q.data_ptr(), s.data_ptr(), n, out.data_ptr(), DTYPE_CODES[dtype],
        host, 0, torch._C._cuda_getCurrentRawStream(dev))
    _check_err(lib, err, "offload_dequantize launch")
    dequantize_blocked.launches += 1
    return out


quantize_blocked.launches = 0
dequantize_blocked.launches = 0
