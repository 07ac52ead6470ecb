"""Mamba-2 SSD intra-chunk forward: the quadratic (dual) form within each
chunk and the chunk's contribution to the inter-chunk state, in one call.

``ssd_intra_chunk_fwd(xc, dtc, da, bc, cc)`` takes xc (B,NC,Q,H,P) in fp32
or bf16, dtc and da (B,NC,Q,H) fp32 and bc, cc (B,NC,Q,N) fp32, with
1 <= Q <= 256 and 1 <= P <= 128, and returns y_diag (B,NC,Q,H,P) and
states (B,NC,H,P,N), both fp32.  On a CUDA tensor it launches one
hand-written kernel of ``csrc/ssd_scan.cu`` (they replace the Pallas kernel
``ssd_intra_chunk_fwd`` of the JAX package's ``kernels/ssd_scan.py``): for
bf16 x, ``ssd_fwd``, whose work items compute y for groups of heads over
one C.B^T and the chunk states, with 3xTF32 products on the tensor cores;
for fp32 x, ``ssd_fwd_simt``, fp32 sums on the CUDA cores in the plain
path's order.  On a CPU tensor it runs ``ref.ssd_intra_chunk_ref``.  The
wrapper counts its calls, one device kernel each, in ``.launches``.

Forward only, as in the JAX package, where ``jax.grad`` through the Pallas
call fails: with grad mode on and an input that requires grad it raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .ref import ssd_intra_chunk_ref

MAX_CHUNK = 256
MAX_HEAD_DIM = 128
X_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("ssd_scan")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.ssd_intra_chunk_fwd.argtypes = [ptr] * 7 + [ctypes.c_int] \
        + [i64] * 5 + [ptr]
    lib.ssd_intra_chunk_fwd.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(xc, dtc, da, bc, cc) -> None:
    if xc.dim() != 5:
        raise ValueError(f"xc must be (B,NC,Q,H,P), got {tuple(xc.shape)}")
    b, nc, q, h, p = xc.shape
    if dtc.shape != (b, nc, q, h) or da.shape != (b, nc, q, h):
        raise ValueError(f"dtc and da must be {(b, nc, q, h)}, got "
                         f"{tuple(dtc.shape)} and {tuple(da.shape)}")
    if bc.dim() != 4 or bc.shape[:3] != (b, nc, q) or cc.shape != bc.shape:
        raise ValueError(f"bc and cc must be ({b}, {nc}, {q}, N), got "
                         f"{tuple(bc.shape)} and {tuple(cc.shape)}")
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"chunk length {q} is outside 1..{MAX_CHUNK}")
    if not 1 <= p <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {p} is outside 1..{MAX_HEAD_DIM}")
    if bc.shape[3] < 1:
        raise ValueError("the state dim N must be at least 1")
    if xc.dtype not in X_DTYPES:
        raise TypeError(f"xc dtype {xc.dtype} is not float32 or bfloat16")
    if any(t.dtype != torch.float32 for t in (dtc, da, bc, cc)):
        raise TypeError("dtc, da, bc and cc must be float32")
    if any(t.device != xc.device for t in (dtc, da, bc, cc)):
        raise ValueError("all inputs must be on one device")
    if xc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xc.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in
                                       (xc, dtc, da, bc, cc)):
        raise RuntimeError(
            "ssd_intra_chunk_fwd is forward-only (the JAX kernel has no "
            "backward either); call it under torch.no_grad() or "
            "torch.inference_mode(), or use the plain chunked path")


def ssd_intra_chunk_fwd(xc: torch.Tensor, dtc: torch.Tensor,
                        da: torch.Tensor, bc: torch.Tensor, cc: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y_diag (B,NC,Q,H,P) and states (B,NC,H,P,N), fp32: see the module
    docstring.  Non-contiguous inputs are copied."""
    _check(xc, dtc, da, bc, cc)
    if xc.device.type == "cpu":
        return ssd_intra_chunk_ref(xc, dtc, da, bc, cc)
    xc, dtc, da, bc, cc = (t.contiguous() for t in (xc, dtc, da, bc, cc))
    b, nc, q, h, p = xc.shape
    n = bc.shape[3]
    y = torch.empty((b, nc, q, h, p), dtype=torch.float32, device=xc.device)
    st = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=xc.device)
    if y.numel() == 0:
        return y, st
    lib = _lib()
    with torch.cuda.device(xc.device):
        err = lib.ssd_intra_chunk_fwd(
            xc.data_ptr(), dtc.data_ptr(), da.data_ptr(), bc.data_ptr(),
            cc.data_ptr(), y.data_ptr(), st.data_ptr(),
            int(xc.dtype == torch.bfloat16), b * nc, q, h, p, n,
            torch.cuda.current_stream(xc.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ssd_scan launch failed: "
                           + lib.ssd_scan_error_string(err).decode())
    ssd_intra_chunk_fwd.launches += 1
    return y, st


ssd_intra_chunk_fwd.launches = 0
