"""The arithmetic of the port's SSD intra-chunk kernel, modelled on the CPU,
against the JAX package's Pallas kernel.

For bf16 x (the model's prefill) ``csrc/ssd_scan.cu`` runs its products on
the tensor cores in TF32, whose 10-bit mantissa alone misses the
reference's 1e-4 (rtol = atol, ``tests/test_kernels.py:66-68``) by far.
It splits every fp32 operand a into hi = tf32(a), rounded to nearest with
ties away from zero (PTX ``cvt.rna``), and lo = tf32(a - hi), and sums
lo.hi + hi.lo + hi.hi in fp32 (lo.hi + hi.hi against bf16 x, which TF32
holds exactly).  (fp32 x takes the CUDA cores in the plain path's order.)
``_kernel_model`` does that arithmetic in plain torch: C.B^T computed once
and shared by all heads, the weights formed from it and split, the
products summed tile by tile in the kernel's order (64-row tiles of y,
64-position tiles of the state; within a tile torch's fp32 matmul stands
for the tensor core's sums).  The same numpy inputs go to the Pallas
kernel in interpret mode, as the reference's own tests run it, and the
model must hold its 1e-4 at the reference's sweep, a ragged chunk and
Mamba-2 780M's 48 heads, all with bf16 x.  The model with a single TF32
product must fail it, so the check has teeth.

The prefix sums are handed over.  The Pallas kernel sums dA in fp32
(``jnp.cumsum``); the kernel and the port's plain version sum in double
and round once (``cumsum64``; an fp32 sum failed the 1e-4 on the card).
At Q 200 and 256 that difference alone moves y past the tolerance, for
the plain version as much as for the model.  So the model starts from the
Pallas kernel's own prefix sums when it is held to that kernel, and from
``cumsum64``, as the kernel does, when it is held to the plain version,
which is what the card checks the kernel against
(``test_torch_cuda_kernels.py``, ``chip_smoke.py``).

What the model leaves out.  It runs no code of the port, and by default
torch's fp32 matmul sums each tile, rounding to nearest, where the tensor
cores truncate their fp32 sums.  That truncation shaped the kernel: summed
in one fragment over N = 128, C.B^T put the prefill shape near the
tolerance on an H100, so the kernel sums each 8-wide step of C.B^T in a
fresh fragment.  ``_scores`` models it for C.B^T alone (each m16n8k8
product summed exactly, then rounded toward zero into its fragment), and
a test holds the fresh fragments against one fragment over N at the
prefill shape.  Even so, the model reads lower shares of the tolerance
than the card does (the card's own sums are not exact before they are
truncated), so only the card test (``test_torch_cuda_kernels.py``) and
``chip_smoke.py`` settle whether the kernel holds 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import ssd_intra_chunk as jax_ssd_intra_chunk
from repro_torch.kernels.ref import cumsum64, ssd_intra_chunk_ref

TOL = 1e-4
TILE = 64        # rows of y and positions of the state per kernel step

# (B, NC, Q, H, P, N), x in bf16: the reference's sweep, a ragged chunk,
# and Mamba-2 780M's heads (48 of 64, state 128) at its chunk of 256
SHAPES = [(2, 3, 64, 4, 16, 32),
          (1, 2, 128, 2, 64, 128),
          (1, 5, 32, 8, 64, 16),
          (1, 1, 200, 4, 64, 128),
          (1, 2, 256, 48, 64, 128)]


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as PTX ``cvt.rna.tf32.f32``: add half of the 13 dropped bits'
    range to the magnitude, then clear them (finite inputs)."""
    bits = a.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _parts(a: torch.Tensor, split: bool):
    """(hi, lo) of the kernel's split; lo is None for a single product."""
    hi = tf32_rna(a)
    return hi, (tf32_rna(a - hi) if split else None)


def _product(eq: str, acc, a, b):
    """acc + a.b in the kernel's order of terms, a and b as (hi, lo):
    lo_a.hi_b, hi_a.lo_b, then hi_a.hi_b, each added to the fp32 sum."""
    (ah, al), (bh, bl) = a, b
    for x, y in ((al, bh), (ah, bl), (ah, bh)):
        if x is not None and y is not None:
            acc = acc + torch.einsum(eq, x, y)
    return acc


def _round_toward_zero(a: torch.Tensor) -> torch.Tensor:
    """float64 to fp32, rounded toward zero."""
    r = a.float()
    over = r.double().abs() > a.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _scores(cp, bp, sums: str = "fp32"):
    """C.B^T from the (hi, lo) parts of C and B, in the kernel's order of
    terms.  ``sums``: "fp32", torch's fp32 matmul over all of N; "fresh",
    as the kernel sums: each 8-wide step of N (one m16n8k8 product per
    term) into a fresh fragment, each product summed exactly and rounded
    toward zero into it, the steps added in fp32; "one", every step's
    products truncated into one fragment over N."""
    if sums == "fp32":
        return _product("bcin,bcjn->bcij", 0.0, cp, bp)
    (ch, cl), (bh, bl) = cp, bp
    acc = torch.zeros(ch.shape[:-1] + bh.shape[-2:-1])
    for k0 in range(0, ch.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        frag = torch.zeros_like(acc) if sums == "fresh" else acc
        for x, y in ((cl, bh), (ch, bl), (ch, bh)):
            part = torch.einsum("bcin,bcjn->bcij", x[..., ks].double(),
                                y[..., ks].double())
            frag = _round_toward_zero(frag.double() + part)
        acc = acc + frag if sums == "fresh" else frag
    return acc


def _kernel_model(xc, dtc, da, bc, cc, split: bool = True, cum=None,
                  sums: str = "fp32"):
    """y_diag (B,NC,Q,H,P) and states (B,NC,H,P,N) as the kernel computes
    them (see the module docstring), from the prefix sums ``cum`` of dA
    (the kernel's ``cumsum64`` by default); ``split=False`` keeps only the
    hi.hi product of every pair; ``sums`` says how C.B^T is summed
    (``_scores``, with ``split``)."""
    b, nc, q, h, p = xc.shape
    assert xc.dtype == torch.bfloat16
    x = xc.float()
    xp = (x, None)                      # bf16 is exact in TF32: no lo part
    dt = dtc.float()
    if cum is None:
        cum = cumsum64(da.float(), 2)                   # (B,NC,Q,H)
    cp, bp = _parts(cc.float(), split), _parts(bc.float(), split)
    y = torch.zeros((b, nc, q, h, p))
    for i0 in range(0, q, TILE):
        i1 = min(q, i0 + TILE)
        # the scores of rows i0..i1 against columns 0..i1, once for all heads
        s = _scores(tuple(t[:, :, i0:i1] if t is not None else None
                          for t in cp),
                    tuple(t[:, :, :i1] if t is not None else None
                          for t in bp), sums)
        rows = torch.arange(i0, i1)[:, None]
        cols = torch.arange(i1)[None, :]
        mask = (cols <= rows)[None, None, :, :, None]
        diff = cum[:, :, i0:i1, None, :] - cum[:, :, None, :i1, :]
        decay = torch.where(mask, torch.exp(diff), torch.zeros(()))
        w = s[..., None] * decay * dt[:, :, None, :i1, :]   # (B,NC,R,J,H)
        wp = _parts(w, split)
        acc = torch.zeros((b, nc, i1 - i0, h, p))
        for j0 in range(0, i1, TILE):
            js = slice(j0, min(i1, j0 + TILE))
            acc = _product("bcrjh,bcjhp->bcrhp", acc,
                           tuple(t[:, :, :, js] if t is not None else None
                                 for t in wp),
                           tuple(t[:, :, js] if t is not None else None
                                 for t in xp))
        y[:, :, i0:i1] = acc
    wq = torch.exp(cum[:, :, -1:] - cum) * dt                # (B,NC,Q,H)
    ap = _parts(wq[..., None] * bc.float()[:, :, :, None, :], split)
    st = torch.zeros((b, nc, h, bc.shape[-1], p))
    for q0 in range(0, q, TILE):
        qs = slice(q0, min(q, q0 + TILE))
        st = _product("bcqhn,bcqhp->bchnp", st,
                      tuple(t[:, :, qs] if t is not None else None
                            for t in ap),
                      tuple(t[:, :, qs] if t is not None else None
                            for t in xp))
    return y, st.transpose(-1, -2)


def _inputs(b, nc, q, h, p, n, seed=0):
    """The reference test's draws, from numpy: normal x, B and C,
    softplus-normal dt and minus softplus-normal dA."""
    rng = np.random.default_rng(seed)

    def softplus(a):
        return np.log1p(np.exp(a)).astype(np.float32)

    return (rng.standard_normal((b, nc, q, h, p), dtype=np.float32),
            softplus(rng.standard_normal((b, nc, q, h), dtype=np.float32)),
            -softplus(rng.standard_normal((b, nc, q, h), dtype=np.float32)),
            rng.standard_normal((b, nc, q, n), dtype=np.float32),
            rng.standard_normal((b, nc, q, n), dtype=np.float32))


def _both(shape):
    """The draws for both packages, x rounded once to bf16 on each side."""
    arrays = _inputs(*shape)
    jx = [jnp.asarray(a) for a in arrays]
    jx[0] = jx[0].astype(jnp.bfloat16)
    pt = [torch.from_numpy(a) for a in arrays]
    pt[0] = pt[0].bfloat16()
    return jx, pt


def _reference_cum(jx) -> torch.Tensor:
    """The Pallas kernel's prefix sums of dA: fp32 ``jnp.cumsum``."""
    return torch.from_numpy(np.array(jnp.cumsum(jx[2], axis=2)))


@pytest.mark.parametrize("shape", SHAPES)
def test_split_tf32_model_matches_reference_kernel(shape):
    jx, pt = _both(shape)
    y_j, st_j = jax_ssd_intra_chunk(*jx)
    y, st = _kernel_model(*pt, cum=_reference_cum(jx))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_split_tf32_model_matches_plain_version(shape):
    """With its own prefix sums, the model against what the card holds the
    kernel to: the port's plain version, fp32 throughout."""
    _, pt = _both(shape)
    y, st = _kernel_model(*pt)
    y_r, st_r = ssd_intra_chunk_ref(*pt)
    torch.testing.assert_close(y, y_r, rtol=TOL, atol=TOL)
    torch.testing.assert_close(st, st_r, rtol=TOL, atol=TOL)


def test_single_tf32_product_misses_the_tolerance():
    jx, pt = _both((1, 2, 128, 2, 64, 128))
    y_j, st_j = jax_ssd_intra_chunk(*jx)
    y, st = _kernel_model(*pt, split=False, cum=_reference_cum(jx))
    for got, want in ((y, y_j), (st, st_j)):
        want = torch.from_numpy(np.array(want))
        assert not torch.allclose(got, want, rtol=TOL, atol=TOL)
        # and by far: the worst element is several times the tolerance
        # (about 260 for y, 7 for the states, whose x is exact)
        share = ((got - want).abs() / (TOL + TOL * want.abs())).max()
        assert share > 5


def test_truncating_sums_of_scores_need_fresh_fragments():
    """At Mamba-2 780M's heads, C.B^T truncated into one fragment over N
    comes near the tolerance against the plain version; summed in a fresh
    fragment per 8-wide step, as the kernel does, it stays well inside."""
    _, pt = _both(SHAPES[-1])
    y_r, _ = ssd_intra_chunk_ref(*pt)

    def share(sums):
        y, _ = _kernel_model(*pt, sums=sums)
        return float(((y - y_r).abs() / (TOL + TOL * y_r.abs())).max())

    fresh, one = share("fresh"), share("one")
    assert fresh < 1
    assert one > 0.5 and one > 3 * fresh


def test_round_toward_zero():
    ulp = 2.0 ** -23                    # fp32's ulp at 1
    a = torch.tensor([1.0 + 1.9 * ulp, -(1.0 + 1.9 * ulp), 1.0 + 0.1 * ulp,
                      3.0, -0.0], dtype=torch.float64)
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 3.0, -0.0])
    got = _round_toward_zero(a)
    assert torch.equal(got, want)
    assert bool(torch.signbit(got[-1]))


def test_tf32_rounding_to_nearest_ties_away():
    ulp = 2.0 ** -10                    # TF32's ulp at 1
    values = torch.tensor([
        1.0, 1.0 + ulp, 0.0, -0.0,      # already TF32: unchanged
        1.0 + ulp / 2,                  # tie: away from zero
        -(1.0 + ulp / 2),
        1.0 + 3 * ulp / 2,              # tie above an odd mantissa: up
        1.0 + ulp / 2 - 2.0 ** -23,     # just below the tie: down
        1.0 + ulp / 2 + 2.0 ** -23,     # just above: up
        2.0 - 2.0 ** -23])              # up into the next binade
    want = torch.tensor([
        1.0, 1.0 + ulp, 0.0, -0.0, 1.0 + ulp, -(1.0 + ulp), 1.0 + 2 * ulp,
        1.0, 1.0 + ulp, 2.0])
    got = tf32_rna(values)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got[2:4]), torch.tensor([False, True]))
    # any normal value: 13 low bits clear, within half a TF32 ulp
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10000).astype(np.float32) * 1e3)
    r = tf32_rna(a)
    assert not bool((r.view(torch.int32) & 0x1FFF).any())
    assert bool(((r - a).abs() <= a.abs() * 2.0 ** -11).all())
    # hi + lo carries about 22 bits
    lo = tf32_rna(a - r)
    assert bool(((r + lo - a).abs() <= a.abs() * 2.0 ** -21).all())
