"""Weights and batches made from a run's seed, on the run's device.

The same seed gives the same values on a device, so the program's state
and the reference's are made by the same calls, each side at the time it
needs them.  The normal draws of all parameters are one generator stream
in a few large calls (``DRAW_ELEMENTS`` at a time), in the dtype the
parameters are served in; constants are filled.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

# elements drawn per call: 2**28 bf16 values are 512 MiB
DRAW_ELEMENTS = 1 << 28
# keeps the weight and the batch streams of one seed apart
BATCH_STREAM = 0x5DEECE66D


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def make_params(specs: Sequence, seed: int, device: torch.device,
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Each spec's tensor (its own storage) in ``dtype``: a normal leaf
    from the seed's stream times its scale, a constant leaf filled."""
    gen = _generator(seed, device)
    drawn = [s for s in specs if s.init[0] == "normal"]
    total = sum(math.prod(s.shape) for s in drawn)
    out: Dict[str, torch.Tensor] = {}
    buf = torch.empty(0, dtype=dtype, device=device)
    pos = 0
    for s in drawn:
        n = math.prod(s.shape)
        parts = []
        while n:
            if pos == buf.numel():
                buf = torch.randn(min(DRAW_ELEMENTS, total), generator=gen,
                                  dtype=dtype, device=device)
                total -= buf.numel()
                pos = 0
            take = min(n, buf.numel() - pos)
            parts.append(buf[pos:pos + take])
            pos += take
            n -= take
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        out[s.name] = (flat * s.init[1]).view(s.shape)
    del buf
    for s in specs:
        if s.init[0] == "const":
            out[s.name] = torch.full(s.shape, s.init[1], dtype=dtype,
                                     device=device)
    return {s.name: out[s.name] for s in specs}


def make_batches(seed: int, count: int, batch: int, seq: int, vocab: int,
                 device: torch.device) -> List[Tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """``count`` batches of ``batch`` rows: token ids uniform over
    ``vocab`` for ``seq + 1`` positions; the tokens are the first ``seq``,
    the labels the last ``seq`` (next-token prediction).  No two rows are
    alike (checked)."""
    gen = _generator(seed ^ BATCH_STREAM, device)
    ids = torch.randint(0, vocab, (count * batch, seq + 1), generator=gen,
                        device=device, dtype=torch.int64).to(torch.int32)
    rows = ids[:, :8].cpu()
    if len({tuple(r.tolist()) for r in rows}) != rows.shape[0]:
        raise ValueError("two rows of the batch pool start alike")
    ids = ids.view(count, batch, seq + 1)
    return [(ids[i, :, :-1].contiguous(), ids[i, :, 1:].contiguous())
            for i in range(count)]
