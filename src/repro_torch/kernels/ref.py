"""Plain PyTorch versions of the port's kernels (the bit-exact targets).

Each is a straightforward row loop, independent of the kernel it checks
and of PyTorch's fused indexing operators.  Unlike the JAX oracles, the
scatter writes into ``pool`` in place, as the kernel does.
"""
from __future__ import annotations

from typing import Sequence

import torch


def kv_block_gather_ref(pool: torch.Tensor,
                        idx: Sequence[int]) -> torch.Tensor:
    """pool: (N,W); idx: (K,) ints -> (K,W) copies of the rows ``idx``."""
    out = torch.empty((len(idx), pool.shape[1]), dtype=pool.dtype,
                      device=pool.device)
    for k, i in enumerate(idx):
        out[k].copy_(pool[int(i)])
    return out


def kv_block_scatter_ref(pool: torch.Tensor, idx: Sequence[int],
                         blocks: torch.Tensor) -> torch.Tensor:
    """pool: (N,W); idx: (K,) ints; blocks: (K,W).  Writes ``blocks[k]``
    into row ``idx[k]`` of ``pool`` in place and returns ``pool``; every
    other row is untouched."""
    for k, i in enumerate(idx):
        pool[int(i)].copy_(blocks[k])
    return pool
