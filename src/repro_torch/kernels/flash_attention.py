"""Flash-attention forward: GQA online-softmax attention in one launch.

``flash_attention_fwd(q, k, v, *, causal=True, sliding_window=0)`` takes
q (B,Sq,H,D) and k, v (B,Skv,KV,D) with H % KV == 0 and D <= 256, all fp32
or all bf16, and returns (B,Sq,H,D) in q's dtype.  On a CUDA tensor it
launches the hand-written kernel of ``csrc/flash_attention.cu`` (it
replaces the Pallas kernel ``flash_attention_fwd`` of the JAX package's
``kernels/flash_attention.py``): bf16 always on the tensor cores, fp32
always on the CUDA cores.  On a CPU tensor it runs
``ref.flash_attention_ref``.  The wrapper counts its kernel launches in
``.launches``.

Forward only, as in the JAX package, where ``jax.grad`` through the Pallas
call fails: with grad mode on and an input that requires grad it raises
instead of letting autograd differentiate anything.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .ref import flash_attention_ref

MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("flash_attention")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.flash_attention_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ctypes.c_int, i64, i64, i64, i64, i64, i64,
        ctypes.POINTER(i64), ctypes.c_int, i64, ctypes.c_float, ptr]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           sliding_window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,Sq,H,D) and k, v (B,Skv,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must share q's batch and head dim; got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    kvh = k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} "
                         f"kv heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is outside 1..{MAX_HEAD_DIM}")
    if q.dtype not in DTYPES:
        raise TypeError(f"dtype {q.dtype} is not float32 or bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if sliding_window < 0:
        raise ValueError(f"sliding_window must be >= 0, got {sliding_window}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_fwd is forward-only (the JAX kernel has no "
            "backward either); call it under torch.no_grad() or "
            "torch.inference_mode(), or use the plain attention paths")


def _head_strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def _tma_ready(t: torch.Tensor) -> bool:
    """What the bf16 kernel's TMA copies need: base 16-byte aligned, unit
    stride in D, the other strides multiples of 8 elements (16 bytes)."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in _head_strides(t)))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sliding_window: int = 0) -> torch.Tensor:
    """Attention of q over k, v with an fp32 online softmax; masked scores
    take -1e30.  Sequence lengths may differ (non-causal cross shapes) and
    be ragged.  Tensors the kernel cannot read in place are copied: a head
    dim that is not unit-stride; for bf16 also a base that is not 16-byte
    aligned or a stride that is not a multiple of 8 elements, and a head
    dim that is not a multiple of 8 is zero-padded to one."""
    _check(q, k, v, sliding_window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   sliding_window=sliding_window)
    d = q.shape[3]
    scale = float(np.float32(1.0 / np.sqrt(d)))    # the reference's f32 scale
    bf16 = q.dtype == torch.bfloat16
    if bf16 and d % 8:
        # zero columns of q and k add nothing to a score, and those of v
        # give output columns that are cut off
        q, k, v = (torch.nn.functional.pad(t, (0, -d % 8)) for t in (q, k, v))
    ready = _tma_ready if bf16 else (lambda t: t.stride(-1) == 1)
    q, k, v = (t if ready(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    b, sq, h, dp = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, dp), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out[..., :d]
    strides = (ctypes.c_int64 * 12)(*_head_strides(q), *_head_strides(k),
                                    *_head_strides(v), *_head_strides(out))
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(bf16), b, sq, skv, h, kvh, dp, strides,
            int(causal), int(sliding_window), scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention_fwd.launches += 1
    return out if dp == d else out[..., :d].contiguous()


flash_attention_fwd.launches = 0
