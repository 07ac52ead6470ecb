"""Device selection for the port's entry points.

Every entry point takes ``device``.  The default is the CUDA card; the CPU
is used only when the caller asks for it by name (the tests do).  A missing
card is an error, never a quiet fallback to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``.  Raises ``RuntimeError`` when the resolved
    device is a CUDA device and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (a tensor on a device mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)
