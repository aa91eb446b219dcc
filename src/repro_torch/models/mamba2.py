"""Mamba2 (SSD) block, the port of `repro.models.mamba2`: the chunked scan
for training and prefill, the O(1)-state recurrence for decode.  Used by
zamba2-7b's backbone.

As in the reference: one B/C group shared by the heads, a depthwise causal
conv (K = 4) over the x and B/C streams, a scalar A per head, and the SSD
paper's chunked algorithm (an intra-chunk quadratic term plus the
inter-chunk state carried from chunk to chunk, here by a Python loop where
the reference scans).  The dtype points are the reference's: the gate math
(cumsum, exp) in f32, the (B, Q, Q, H) decay product cast to the compute
dtype before its product, the carried state in f32.  One deviation: the
decay is masked before its exp (`masked_decay`), where the reference
masks after it and overflows to NaN on long decays.

DSG site: the SiLU-gated z branch.  `gate_mask` is the expanded neuron
mask of the DRS over z (`models/recurrent.py`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init

CONV_K = 4


class Mamba2Dims(NamedTuple):
    d: int          # model dim
    d_in: int       # inner dim (expand * d)
    heads: int      # H
    head_dim: int   # P = d_in / H
    n: int          # state size N
    chunk: int


def dims(d_model: int, expand: int, n_state: int, heads: int,
         chunk: int) -> Mamba2Dims:
    d_in = expand * d_model
    h = heads or max(1, d_in // 64)
    return Mamba2Dims(d_model, d_in, h, d_in // h, n_state, chunk)


class Mamba2(nn.Module):
    """The reference's split in-projection (w_z, w_x (d, d_in), w_bcdt
    (d, 2N + H)), the conv taps (K, C), the per-head a_log, dt_bias and
    d_skip (f32 in every model dtype) and w_out (d_in, d)."""

    def __init__(self, w_z, w_x, w_bcdt, conv_x, conv_bc, a_log, dt_bias,
                 d_skip, w_out):
        super().__init__()
        for name, t in (("w_z", w_z), ("w_x", w_x), ("w_bcdt", w_bcdt),
                        ("conv_x", conv_x), ("conv_bc", conv_bc),
                        ("a_log", a_log), ("dt_bias", dt_bias),
                        ("d_skip", d_skip), ("w_out", w_out)):
            setattr(self, name, nn.Parameter(t, requires_grad=False))


def init_mamba2(dm: Mamba2Dims, *, generator: Optional[torch.Generator],
                dtype: torch.dtype, device=None) -> Mamba2:
    kw = dict(generator=generator, dtype=dtype, device=device)

    def conv(c):
        return (torch.randn((CONV_K, c), generator=generator, device=device)
                / math.sqrt(CONV_K)).to(dtype)
    f32 = dict(dtype=torch.float32, device=device)
    return Mamba2(dense_init((dm.d, dm.d_in), dm.d, **kw),
                  dense_init((dm.d, dm.d_in), dm.d, **kw),
                  dense_init((dm.d, 2 * dm.n + dm.heads), dm.d, **kw),
                  conv(dm.d_in), conv(2 * dm.n),
                  torch.zeros(dm.heads, **f32),
                  torch.full((dm.heads,), -2.0, **f32),
                  torch.ones(dm.heads, **f32),
                  dense_init((dm.d_in, dm.d), dm.d_in, **kw))


def _causal_conv(seq: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time.  seq (B, S, C), w (K, C).
    Returns (silu(out) (B, S, C), new_state (B, K-1, C))."""
    k = w.shape[0]
    if state is None:
        state = seq.new_zeros((seq.shape[0], k - 1, seq.shape[-1]))
    padded = torch.cat([state, seq], dim=1)
    s = seq.shape[1]
    out = sum(padded[:, i:i + s] * w[i] for i in range(k))
    return F.silu(out), padded[:, -(k - 1):]


def masked_decay(la: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
    """exp(la_i - la_j) for j <= i, and 0 above the diagonal: (B, Q, Q, H)
    from la (B, Q, H).  The reference takes the exp of every entry and
    then multiplies by the causal mask, so an entry above the diagonal,
    exp of the decay summed over up to Q tokens, overflows f32 once that
    sum passes 88.7, and inf * 0 makes the chunk NaN (zamba2-7b's deeper
    blocks reach it at full width).  Masking before the exp gives the
    reference's values, bit for bit, wherever it is finite."""
    diff = la[:, :, None] - la[:, None]
    return torch.exp(diff.masked_fill(~causal[None, :, :, None],
                                      float("-inf")))


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, dm: Mamba2Dims,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.  xh (B, S, H, P), dt (B, S, H) [post-softplus],
    a (B, S, H) = A * dt (negative), bmat/cmat (B, S, N).  Returns
    (y (B, S, H, P), h_final (B, H, N, P) f32).  A ragged tail is padded
    with dt = 0 tokens (decay 1 and no input: the carried state passes
    through) whose outputs are cut off."""
    b, s, h, p = xh.shape
    q = min(dm.chunk, s)
    if s % q:
        pad = q - s % q

        def zf(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        y, hf = ssd_chunked(zf(xh), zf(dt), zf(a), zf(bmat), zf(cmat), dm,
                            h0)
        return y[:, :s], hf
    if h0 is None:
        h0 = torch.zeros((b, h, dm.n, p), dtype=torch.float32,
                         device=xh.device)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=xh.device))
    hprev, ys = h0, []
    for c in range(s // q):
        sl = slice(c * q, (c + 1) * q)
        x_i, dt_i, a_i, b_i, c_i = (t[:, sl] for t in (xh, dt, a, bmat,
                                                       cmat))
        la = torch.cumsum(a_i, dim=1)                            # (B,Q,H)
        # intra-chunk quadratic term: the (B,Q,Q,H) product in the compute
        # dtype, the gate math in f32
        cb = torch.einsum("bin,bjn->bij", c_i, b_i)              # (B,Q,Q)
        decay = masked_decay(la, causal)                         # (B,Q,Q,H)
        m = (cb[..., None].float() * decay).to(xh.dtype)
        xdt = (x_i.float() * dt_i[..., None]).to(xh.dtype)
        y_intra = torch.einsum("bijh,bjhp->bihp", m, xdt)
        # inter-chunk, from the carried state
        y_inter = torch.einsum("bin,bhnp->bihp", c_i.float(),
                               hprev) * torch.exp(la)[..., None]
        # the chunk's contribution to the state
        w = torch.exp(la[:, -1:] - la) * dt_i                    # (B,Q,H)
        s_c = torch.einsum("bjn,bjhp->bhnp", b_i.float(),
                           x_i.float() * w[..., None])
        hprev = hprev * torch.exp(la[:, -1])[:, :, None, None] + s_c
        ys.append((y_intra.float() + y_inter).to(xh.dtype))
    return torch.cat(ys, dim=1), hprev


def mamba2_forward(p: Mamba2, x: torch.Tensor, dm: Mamba2Dims,
                   state: Optional[dict] = None,
                   gate_mask: Optional[torch.Tensor] = None,
                   heads: Optional[slice] = None):
    """The full block.  Training and prefill: state None.  Returns (y,
    new_state) with new_state {'ssm': (B, H, N, P) f32, 'conv_x': (B, K-1,
    d_in), 'conv_bc': (B, K-1, 2N)}; a single token with a state takes the
    one-step recurrence.  gate_mask (B, S, d_in), when given, multiplies
    the SiLU gate (the DSG site).  `heads` (inside a tensor-parallel body)
    names the heads whose columns of w_z, w_x and conv_x and rows of
    w_out `p` holds, and whose part of the state it takes and gives; the
    per-head leaves, w_bcdt and conv_bc are whole.  y is then this
    rank's partial sum of the out-projection."""
    z = x @ p.w_z
    xs = x @ p.w_x
    bcdt = x @ p.w_bcdt
    bc, dt = bcdt[..., :2 * dm.n], bcdt[..., 2 * dm.n:]
    a_log, dt_bias, d_skip = p.a_log, p.dt_bias, p.d_skip
    if heads is not None:
        dt, a_log, dt_bias, d_skip = (t[..., heads] for t in (dt, a_log,
                                                              dt_bias,
                                                              d_skip))
        dm = dm._replace(d_in=xs.shape[-1], heads=dt.shape[-1])
    xs, new_conv_x = _causal_conv(xs, p.conv_x,
                                  state["conv_x"] if state else None)
    bc, new_conv_bc = _causal_conv(bc, p.conv_bc,
                                   state["conv_bc"] if state else None)
    bmat, cmat = bc.chunk(2, dim=-1)

    pre = dt.float() + dt_bias
    dt = torch.logaddexp(pre, torch.zeros_like(pre))     # softplus, (B,S,H)
    a = -torch.exp(a_log) * dt                           # (B,S,H)
    xh = xs.reshape(xs.shape[:2] + (dm.heads, dm.head_dim))

    h0 = state["ssm"] if state else None
    if x.shape[1] == 1 and state is not None:
        # decode: the single-step recurrence
        xdt = xh[:, 0].float() * dt[:, 0, :, None]                # (B,H,P)
        s_c = torch.einsum("bn,bhp->bhnp", bmat[:, 0].float(), xdt)
        h_final = h0 * torch.exp(a[:, 0])[:, :, None, None] + s_c
        y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].float(),
                         h_final)[:, None]                        # (B,1,H,P)
    else:
        y, h_final = ssd_chunked(xh, dt, a, bmat, cmat, dm, h0)

    y = y + xh.float() * d_skip[:, None]
    y = y.reshape(x.shape[0], x.shape[1], dm.d_in).to(x.dtype)
    gate = F.silu(z)
    if gate_mask is not None:
        gate = gate * gate_mask
    out = (y * gate) @ p.w_out
    return out, {"ssm": h_final, "conv_x": new_conv_x,
                 "conv_bc": new_conv_bc}
