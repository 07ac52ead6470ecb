"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) in PyTorch.

The counterpart of the JAX package's ``models/ssm.py``, function for
function.  The chunked SSD forward computes the recurrence within a chunk
as a masked matrix product (the "dual" quadratic form) and carries the
(H, P, N) state across chunks with a short sequential loop; decode is the
O(1) recurrent update.  The projections are separate matrices per
component (z, x, B, C, dt), with the reference's parameter names.

Three differences from the JAX package, none of which changes a forward
value beyond rounding:

* the plain intra-chunk tile takes ``exp`` of the decay only where the
  causal mask keeps it (``exp`` of ``-inf`` elsewhere).  The reference
  takes ``exp`` of every entry and then masks; at full width the masked
  entries overflow to ``inf``, and the backward through them gives NaN
  gradients for dt (ROADMAP §3);
* ``mamba2_decode_step`` writes the cache leaves in place, as the port's
  attention decode does (the JAX version returns new arrays);
* prefix sums of the decay accumulate in float64 on every device
  (``kernels.ref.cumsum64``, what ``torch.cumsum`` does on the CPU), so the
  card's plain path and the kernel round them as the CPU does.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.ref import _segsum, cumsum64
from ..kernels.ssd_scan import ssd_intra_chunk_fwd
from .layers import (ParamTree, constrain, dense_init, ones_init, rmsnorm,
                     zeros_init)


def mamba_dims(cfg) -> Dict[str, int]:
    dinner = cfg.ssm_expand * cfg.d_model
    nheads = dinner // cfg.ssm_head_dim
    return dict(dinner=dinner, nheads=nheads, headdim=cfg.ssm_head_dim,
                nstate=cfg.ssm_state, conv_w=cfg.ssm_conv_width)


class Mamba2(ParamTree):
    """``init_mamba2``: the mixer's parameters, with the reference's names
    and init rules (conv weights at scale 0.5, ``a_log``/``dt_bias`` zeros,
    ``d_skip``/``norm_scale`` ones)."""

    def __init__(self, cfg, *, dtype, device, gen=None,
                 lead: Sequence[int] = ()):
        super().__init__()
        dm = mamba_dims(cfg)
        d, dinner, h, n, w = (cfg.d_model, dm["dinner"], dm["nheads"],
                              dm["nstate"], dm["conv_w"])
        kw = dict(dtype=dtype, device=device, lead=lead)
        self.wz = dense_init(gen, (d, dinner), axes=("embed", "ssm_inner"),
                             **kw)
        self.wx = dense_init(gen, (d, dinner), axes=("embed", "ssm_inner"),
                             **kw)
        self.wb = dense_init(gen, (d, n), axes=("embed", None), **kw)
        self.wc = dense_init(gen, (d, n), axes=("embed", None), **kw)
        self.wdt = dense_init(gen, (d, h), axes=("embed", "ssm_heads"),
                              **kw)
        self.conv_wx = dense_init(gen, (w, dinner), scale=0.5,
                                  axes=(None, "ssm_inner"), **kw)
        self.conv_bx = zeros_init((dinner,), axes=("ssm_inner",), **kw)
        self.conv_wb = dense_init(gen, (w, n), scale=0.5, axes=(None, None),
                                  **kw)
        self.conv_bb = zeros_init((n,), axes=(None,), **kw)
        self.conv_wc = dense_init(gen, (w, n), scale=0.5, axes=(None, None),
                                  **kw)
        self.conv_bc = zeros_init((n,), axes=(None,), **kw)
        self.a_log = zeros_init((h,), axes=("ssm_heads",), **kw)
        self.d_skip = ones_init((h,), axes=("ssm_heads",), **kw)
        self.dt_bias = zeros_init((h,), axes=("ssm_heads",), **kw)
        self.norm_scale = ones_init((dinner,), axes=("ssm_inner",), **kw)
        self.out_proj = dense_init(gen, (dinner, d),
                                   axes=("ssm_inner", "embed"), **kw)


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (B,S,C); w: (W,C) depthwise.  Returns (silu(out), new_state);
    ``new_state`` is a new tensor (the last W-1 inputs), never a view of
    ``state``."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], width - 1, u.shape[2]),
                          dtype=u.dtype, device=u.device)
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    out = sum(full[:, i:i + u.shape[1]] * w[i] for i in range(width))
    new_state = full[:, -(width - 1):] if width > 1 else pad
    return F.silu(out + b), new_state


def _project(p, x: torch.Tensor, cfg, conv_state=None):
    """x: (B,S,d) -> z, xh, bb, cc, dt (+ new conv states)."""
    z = torch.einsum("bsd,di->bsi", x, p["wz"])
    xc = torch.einsum("bsd,di->bsi", x, p["wx"])
    bb = torch.einsum("bsd,dn->bsn", x, p["wb"])
    cc = torch.einsum("bsd,dn->bsn", x, p["wc"])
    dt = torch.einsum("bsd,dh->bsh", x, p["wdt"])
    cs = conv_state or {}
    xc, s_x = _causal_conv(xc, p["conv_wx"], p["conv_bx"], cs.get("x"))
    bb, s_b = _causal_conv(bb, p["conv_wb"], p["conv_bb"], cs.get("b"))
    cc, s_c = _causal_conv(cc, p["conv_wc"], p["conv_bc"], cs.get("c"))
    new_cs = {"x": s_x, "b": s_b, "c": s_c}
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return z, xc, bb, cc, dt, new_cs


def _tile(da_t, dt_t, x_t, b_t, c_t):
    """One chunk of the plain path.  da_t/dt_t: (B,Q,H); x_t: (B,Q,H,P);
    b_t/c_t: (B,Q,N).  Returns y (B,Q,H,P) and the chunk state (B,H,P,N),
    fp32; the (B,H,Q,Q) decay and score tiles live only inside, and the
    decay is 0 above the diagonal (``exp`` of ``_segsum``'s -inf)."""
    cum = cumsum64(da_t, 1)                                # (B,Q,H)
    lm = torch.exp(_segsum(da_t.transpose(1, 2)))          # (B,H,Q,K)
    sc = torch.einsum("bqn,bkn->bqk", c_t, b_t)            # (B,Q,K)
    w = sc[:, None] * lm * dt_t.transpose(1, 2)[:, :, None, :]
    x32 = x_t.float()
    y_t = torch.einsum("bhqk,bkhp->bqhp", w, x32)
    dec_end = torch.exp(cum[:, -1:, :] - cum) * dt_t       # (B,Q,H)
    st_t = torch.einsum("bqh,bqn,bqhp->bhpn", dec_end, b_t, x32)
    return y_t, st_t


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bb: torch.Tensor, cc: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                use_kernel: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.

    xh: (B,S,H,P) value heads; dt: (B,S,H) (post-softplus);
    a: (H,) negative decay rates; bb/cc: (B,S,N).
    Returns y: (B,S,H,P) in xh's dtype, final_state: (B,H,P,N) fp32.
    With ``use_kernel`` the intra-chunk part runs through
    ``kernels.ssd_scan.ssd_intra_chunk_fwd`` (forward only); otherwise it
    runs chunk by chunk, each chunk under ``torch.utils.checkpoint`` when
    autograd is on (the reference's ``jax.checkpoint(tile)``).
    """
    b, s, h, p = xh.shape
    n = bb.shape[-1]
    q = min(chunk, s)
    pad = -s % q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bb = F.pad(bb, (0, 0, 0, pad))
        cc = F.pad(cc, (0, 0, 0, pad))
    nc = (s + pad) // q
    xc = xh.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    bc = bb.reshape(b, nc, q, n)
    ccx = cc.reshape(b, nc, q, n)

    da = dtc * a                                           # (B,nc,Q,H) <= 0
    da_cum = cumsum64(da, 2)
    da_total = da_cum[:, :, -1]                            # (B,nc,H)

    if use_kernel:
        y_diag, states = ssd_intra_chunk_fwd(xc, dtc, da, bc, ccx)
    else:
        remat = torch.is_grad_enabled()
        ys, sts = [], []
        for c in range(nc):
            args = (da[:, c], dtc[:, c], xc[:, c], bc[:, c], ccx[:, c])
            if remat:
                y_t, st_t = checkpoint(_tile, *args, use_reentrant=False)
            else:
                y_t, st_t = _tile(*args)
            ys.append(y_t)
            sts.append(st_t)
        y_diag = torch.stack(ys, dim=1)                    # (B,nc,Q,H,P)
        states = torch.stack(sts, dim=1)                   # (B,nc,H,P,N)

    # inter-chunk recurrence (sequential over chunks)
    chunk_decay = torch.exp(da_total)                      # (B,nc,H)
    if initial_state is None:
        st = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    else:
        st = initial_state.float()
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c].float()
    prev_states = torch.stack(prev, dim=1)                 # (B,nc,H,P,N)

    in_decay = torch.exp(da_cum)                           # (B,nc,Q,H)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", ccx, prev_states) \
        * in_decay[..., None]
    y = (y_diag + y_off).reshape(b, nc * q, h, p)
    return y[:, :s].to(xh.dtype), st


def mamba2_block(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full Mamba-2 mixer over a whole sequence from a zero state.
    x: (B,S,d).  (The reference's ``conv_state``, ``ssm_state`` and
    ``return_state`` have no caller and are left out.)"""
    dm = mamba_dims(cfg)
    z, xc, bb, cc, dt, _ = _project(p, x, cfg)
    h, pd = dm["nheads"], dm["headdim"]
    xh = xc.reshape(*xc.shape[:-1], h, pd)
    xh = constrain(xh, ("dp", None, "tp", None))
    a = -torch.exp(p["a_log"].float())
    y, _ = ssd_chunked(xh, dt, a, bb.float(), cc.float(), cfg.ssm_chunk,
                       use_kernel=cfg.use_flash_kernel)
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(*y.shape[:-2], dm["dinner"])
    y = rmsnorm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    return torch.einsum("bsi,id->bsd", y, p["out_proj"])


# ----------------------------------------------------------------------
# Decode (recurrent, O(1) per token)
# ----------------------------------------------------------------------
def init_ssm_cache(batch: int, cfg, dtype, device,
                   lead: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """Conv states (B, W-1, C) in ``dtype`` and the SSM state (B,H,P,N) in
    fp32; ``lead`` prepends the layer-stack axes."""
    dm = mamba_dims(cfg)
    w = dm["conv_w"] - 1
    lead = tuple(lead)

    def zeros(shape, dt):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    return {
        "conv_x": zeros((batch, w, dm["dinner"]), dtype),
        "conv_b": zeros((batch, w, dm["nstate"]), dtype),
        "conv_c": zeros((batch, w, dm["nstate"]), dtype),
        "state": zeros((batch, dm["nheads"], dm["headdim"], dm["nstate"]),
                       torch.float32),
    }


def ssm_cache_axes() -> Dict[str, Tuple[Optional[str], ...]]:
    """The logical axes of the Mamba-2 cache leaves: the conv state of x
    and the SSM state sharded on ``"tp"`` (channels, heads)."""
    return {"conv_x": ("dp", None, "tp"),
            "conv_b": ("dp", None, None),
            "conv_c": ("dp", None, None),
            "state": ("dp", "tp", None, None)}


def mamba2_decode_step(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                       cfg):
    """x: (B,1,d); cache: {conv_x, conv_b, conv_c, state}.

    Writes EVERY batch row of the cache leaves in place (the JAX version
    returns new arrays; the values are the same).  The new conv states are
    built in temporaries (``_causal_conv`` concatenates) before they are
    copied back, since the shifted window overlaps the old one."""
    dm = mamba_dims(cfg)
    conv_state = {"x": cache["conv_x"], "b": cache["conv_b"],
                  "c": cache["conv_c"]}
    z, xc, bb, cc, dt, new_cs = _project(p, x, cfg, conv_state)
    h, pd = dm["nheads"], dm["headdim"]
    xh = xc[:, 0].reshape(x.shape[0], h, pd)               # (B,H,P)
    dt1 = dt[:, 0]                                         # (B,H) fp32
    a = -torch.exp(p["a_log"].float())
    dec = torch.exp(dt1 * a[None, :])                      # (B,H)
    outer = torch.einsum("bh,bn,bhp->bhpn", dt1, bb[:, 0].float(),
                         xh.float())
    state = cache["state"] * dec[..., None, None] + outer
    y = torch.einsum("bn,bhpn->bhp", cc[:, 0].float(), state)
    y = y + xh.float() * p["d_skip"].float()[None, :, None]
    y = y.reshape(x.shape[0], 1, dm["dinner"]).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"])
    cache["conv_x"].copy_(new_cs["x"])
    cache["conv_b"].copy_(new_cs["b"])
    cache["conv_c"].copy_(new_cs["c"])
    cache["state"].copy_(state)
    return out, cache
