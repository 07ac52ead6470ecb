"""Why the dry run's attention FLOPs exceed the reference's, on the CPU.

The port's chunked attention loops over Q and KV chunks in Python, so
``launch.dryrun.account`` sees every chunk's two matmuls: 4·B·Sq·Skv·H·dh
FLOPs, and for causal attention those of the chunks up to the diagonal
(``_attend_chunked`` stops there).  The reference maps over Q chunks
(``jax.lax.map``) and scans over KV chunks (``jax.lax.scan``) in
``repro.models.attention.attend_chunked``; XLA's cost analysis visits each
loop body once, so it reads one (Q chunk, KV chunk) pair's matmuls plus
that body's elementwise work, whatever the number of chunks: 1/(nq·nk) of
the attention.  At a small shape (B 1, 4 chunks of 16 each way, 2 heads
of 16) the port's count is held to the analytic one exactly, and the
reference's to one body's.  Nothing is timed.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.models.attention import attend_chunked as jax_attend_chunked
from repro_torch.launch import dryrun
from repro_torch.models.attention import attend_chunked

B, CHUNK, N_CHUNKS, HEADS, HEAD_DIM = 1, 16, 4, 2, 16
SEQ = CHUNK * N_CHUNKS
# an upper bound on the FLOPs of the elementwise work of one loop body
# per element of the score tile and of the accumulator it touches (about
# 5 measured here: scale, mask, max, subtract, sum, rescale)
ELEMENTWISE_PER_ELEMENT = 16


def _inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((B, SEQ, HEADS, HEAD_DIM), np.float32)
            for _ in range(3)]


def _analytic(causal: bool) -> int:
    """4·B·H·dh per (q, k) pair of the chunks the port visits: all of them,
    or the nq·(nq + 1)/2 chunk pairs on and below the diagonal."""
    pairs = N_CHUNKS * (N_CHUNKS + 1) // 2 if causal else N_CHUNKS ** 2
    return 4 * B * HEADS * HEAD_DIM * CHUNK * CHUNK * pairs


@pytest.mark.parametrize("causal", [False, True])
def test_port_counts_every_chunk(causal):
    """``account`` counts the port's chunked attention at the analytic
    4·B·Sq·Skv·H·dh (causal: the chunks up to the diagonal), all of it in
    ``aten.bmm``."""
    args = tuple(torch.from_numpy(x) for x in _inputs())
    with torch.no_grad():
        _, acc, _ = dryrun.account(
            lambda q, k, v: attend_chunked(q, k, v, causal=causal,
                                           chunk=CHUNK), args)
    assert acc.flops == _analytic(causal)
    assert dict(acc.flops_by_op) == {"aten.bmm": _analytic(causal)}
    if not causal:
        assert acc.flops == 4 * B * SEQ * SEQ * HEADS * HEAD_DIM


@pytest.mark.parametrize("causal", [False, True])
def test_reference_counts_one_loop_body(causal):
    """The reference's compiled cost analysis of the same attention reads
    one chunk pair's matmuls and at most that body's elementwise work: at
    most 1/(nq·nk) of the non-causal analytic count plus the elementwise
    bound, a fraction of the port's count."""
    body = 4 * B * HEADS * HEAD_DIM * CHUNK * CHUNK
    elementwise = ELEMENTWISE_PER_ELEMENT * B * HEADS * (
        CHUNK * CHUNK + CHUNK * HEAD_DIM)
    fn = jax.jit(functools.partial(jax_attend_chunked, causal=causal,
                                   chunk=CHUNK))
    cost = fn.lower(*_inputs()).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    flops = cost["flops"]
    assert body == _analytic(False) // N_CHUNKS ** 2
    assert body <= flops <= body + elementwise, flops
    assert flops < _analytic(causal) / 4
