"""xLSTM blocks for xlstm-350m, the port of `repro.models.xlstm`: the
mLSTM in chunked-parallel form and the sLSTM as a recurrence.

mLSTM: a matrix-memory LSTM, per head a (Dk x Dv) covariance state with an
exponential input gate and a sigmoid forget gate.  It is a gated linear
attention, so the chunked scan mirrors `mamba2.ssd_chunked`, with
per-head q/k/v and a key-dim normaliser state, all in f32, and its decay
masked before the exp as there (`mamba2.masked_decay`).

sLSTM: a scalar-memory LSTM with exponential gating and a stabiliser
state, a sequential loop over time in f32.  Its recurrent weights are
diagonal (the reference's simplification of block-diagonal ones).

DSG site: the block's up-projection (`models/recurrent.py`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init
from repro_torch.models.mamba2 import masked_decay


class MLSTMDims(NamedTuple):
    d: int
    heads: int
    dk: int     # key/query dim per head
    dv: int     # value dim per head
    chunk: int


def mlstm_dims(d: int, heads: int, chunk: int = 128) -> MLSTMDims:
    return MLSTMDims(d, heads, d // heads, d // heads, chunk)


def _params(module: nn.Module, **tensors) -> None:
    for name, t in tensors.items():
        setattr(module, name, nn.Parameter(t, requires_grad=False))


class MLSTM(nn.Module):
    """w_qkv (d, H(2Dk + Dv)), w_gates (d, 2H) and b_gates (2H,) in f32,
    w_out (H Dv, d), skip (H,) f32 (a leaf of the reference's tree that
    its forward does not read)."""

    def __init__(self, w_qkv, w_gates, b_gates, w_out, skip):
        super().__init__()
        _params(self, w_qkv=w_qkv, w_gates=w_gates, b_gates=b_gates,
                w_out=w_out, skip=skip)


class SLSTM(nn.Module):
    """w_in (d, 4d), the diagonal recurrent weights r_diag (4, d) and bias
    (4d,), both f32."""

    def __init__(self, w_in, r_diag, bias):
        super().__init__()
        _params(self, w_in=w_in, r_diag=r_diag, bias=bias)


def init_mlstm(dm: MLSTMDims, *, generator: Optional[torch.Generator],
               dtype: torch.dtype, device=None) -> MLSTM:
    h, dk, dv = dm.heads, dm.dk, dm.dv
    kw = dict(generator=generator, device=device)
    return MLSTM(
        dense_init((dm.d, h * (2 * dk + dv)), dm.d, dtype=dtype, **kw),
        dense_init((dm.d, 2 * h), dm.d, dtype=torch.float32, **kw),
        torch.cat([torch.zeros(h, device=device),
                   3.0 * torch.ones(h, device=device)]),
        dense_init((h * dv, dm.d), h * dv, dtype=dtype, **kw),
        torch.ones(h, device=device))


def init_slstm(d: int, *, generator: Optional[torch.Generator],
               dtype: torch.dtype, device=None) -> SLSTM:
    return SLSTM(
        dense_init((d, 4 * d), d, generator=generator, dtype=dtype,
                   device=device),
        torch.randn((4, d), generator=generator, device=device) * 0.1,
        torch.cat([torch.zeros(d, device=device),
                   2.0 * torch.ones(d, device=device),
                   torch.zeros(2 * d, device=device)]))


def mlstm_chunked(q, k, v, log_f, i_gate, dm: MLSTMDims, c0=None, n0=None):
    """Chunked gated-linear-attention scan.  q/k/v (B, S, H, D),
    log_f (B, S, H) = log sigmoid(f~), i_gate (B, S, H) >= 0.  State C
    (B, H, Dk, Dv) and normaliser n (B, H, Dk), f32; with no c0 they start
    at zeros and ones.  S must be a multiple of min(chunk, S), as the
    reference asserts."""
    b, s, h, dk = q.shape
    qn = q / math.sqrt(dk)
    qchunk = min(dm.chunk, s)
    if s % qchunk:
        raise ValueError(f"mlstm_chunked: sequence length {s} is not a "
                         f"multiple of the chunk {qchunk}")
    if c0 is None:
        c0 = torch.zeros((b, h, dk, v.shape[-1]), dtype=torch.float32,
                         device=q.device)
        n0 = torch.ones((b, h, dk), dtype=torch.float32, device=q.device)
    causal = torch.tril(torch.ones((qchunk, qchunk), dtype=torch.bool,
                                   device=q.device))
    c_prev, n_prev, ys = c0, n0, []
    for c in range(s // qchunk):
        sl = slice(c * qchunk, (c + 1) * qchunk)
        q_i, k_i, v_i = (t[:, sl].float() for t in (qn, k, v))
        f_i, i_i = log_f[:, sl], i_gate[:, sl]
        lf = torch.cumsum(f_i, dim=1)                           # (B,Q,H)
        decay = masked_decay(lf, causal)                        # (B,Q,Q,H)
        qk = torch.einsum("bihd,bjhd->bijh", q_i, k_i)
        m = qk * decay * i_i[:, None]
        y_intra = torch.einsum("bijh,bjhv->bihv", m, v_i)
        n_intra = m.sum(dim=2)                                  # (B,Q,H)
        y_inter = torch.einsum("bihd,bhdv->bihv", q_i,
                               c_prev) * torch.exp(lf)[..., None]
        n_inter = torch.einsum("bihd,bhd->bih", q_i,
                               n_prev) * torch.exp(lf)
        denom = torch.clamp((n_intra + n_inter).abs(), min=1.0)[..., None]
        y = (y_intra + y_inter) / denom
        w = torch.exp(lf[:, -1:] - lf) * i_i                    # (B,Q,H)
        kw = k_i * w[..., None]
        c_prev = c_prev * torch.exp(lf[:, -1])[:, :, None, None] + \
            torch.einsum("bjhd,bjhv->bhdv", kw, v_i)
        n_prev = n_prev * torch.exp(lf[:, -1])[:, :, None] + kw.sum(dim=1)
        ys.append(y.to(q.dtype))
    return torch.cat(ys, dim=1), (c_prev, n_prev)


def mlstm_core(qkv: torch.Tensor, gates: torch.Tensor, dm: MLSTMDims,
               state: Optional[dict] = None):
    """The mLSTM between its projections: qkv (B, S, H(2Dk + Dv)) and the
    gates' pre-activations (B, S, 2H) f32, with their bias -> (y (B, S,
    H Dv) in qkv's dtype, {'c', 'n'}); a single token with a state takes
    the one-step recurrence."""
    b, s, _ = qkv.shape
    h, dk, dv = dm.heads, dm.dk, dm.dv
    qkv = qkv.reshape(b, s, h, 2 * dk + dv)
    q, k, v = qkv[..., :dk], qkv[..., dk:2 * dk], qkv[..., 2 * dk:]
    i_raw, f_raw = gates.chunk(2, dim=-1)                       # (B,S,H)
    i_gate = torch.exp(torch.clamp(i_raw, max=8.0))  # stabilised exp gate
    log_f = F.logsigmoid(f_raw)

    if s == 1 and state is not None:
        c_prev, n_prev = state["c"], state["n"]
        f1 = torch.exp(log_f[:, 0])                             # (B,H)
        k0 = k[:, 0].float()
        kv = torch.einsum("bhd,bhv->bhdv", k0, v[:, 0].float())
        c_f = c_prev * f1[..., None, None] + \
            i_gate[:, 0][..., None, None] * kv
        n_f = n_prev * f1[..., None] + i_gate[:, 0][..., None] * k0
        qs = q[:, 0].float() / math.sqrt(dk)
        num = torch.einsum("bhd,bhdv->bhv", qs, c_f)
        den = torch.clamp(torch.einsum("bhd,bhd->bh", qs, n_f).abs(),
                          min=1.0)
        y = (num / den[..., None])[:, None]                     # (B,1,H,Dv)
    else:
        y, (c_f, n_f) = mlstm_chunked(
            q, k, v, log_f, i_gate, dm, state["c"] if state else None,
            state["n"] if state else None)
    return y.to(qkv.dtype).reshape(b, s, h * dv), {"c": c_f, "n": n_f}


def mlstm_forward(p: MLSTM, x: torch.Tensor, dm: MLSTMDims,
                  state: Optional[dict] = None):
    """x (B, S, d) -> (out (B, S, d), {'c', 'n'}); with no state C and n
    start at zeros and ones."""
    y, st = mlstm_core(x @ p.w_qkv, x.float() @ p.w_gates + p.b_gates, dm,
                       state)
    return y @ p.w_out, st


def slstm_scan(pre: torch.Tensor, r_diag: torch.Tensor,
               state: Optional[dict] = None):
    """The sLSTM's loop over time in f32 on its gates' input
    pre-activations pre (B, S, 4, d) (z, f, i, o), with the diagonal
    recurrent weights r_diag (4, d): (h over time (B, S, d) f32, state
    {'c', 'n', 'm', 'h'} (B, d)); with no state c, m and h start at zero
    and n at one.  Its channels are independent, so any slice of d runs
    alone."""
    b, s, _, d = pre.shape
    if state is None:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=pre.device)
        state = {"c": zeros, "n": zeros + 1.0, "m": zeros, "h": zeros}
    c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    hs = []
    for t in range(s):
        z_r, f_r, i_r, o_r = (pre[:, t] + r_diag * h[:, None, :]).unbind(1)
        f_m = f_r + m
        m_new = torch.maximum(f_m, i_r)                         # stabiliser
        i_g = torch.exp(i_r - m_new)
        f_g = torch.exp(f_m - m_new)
        c = f_g * c + i_g * torch.tanh(z_r)
        n = f_g * n + i_g
        h = torch.sigmoid(o_r) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), {"c": c, "n": n, "m": m, "h": h}


def slstm_forward(p: SLSTM, x: torch.Tensor, state: Optional[dict] = None):
    """The sLSTM over time, step by step in f32.  x (B, S, d) -> (y (B, S,
    d) in x's dtype, state {'c', 'n', 'm', 'h'} (B, d) f32); with no state
    c, m and h start at zero and n at one."""
    b, s, d = x.shape
    pre = x.float() @ p.w_in.float() + p.bias
    y, st = slstm_scan(pre.view(b, s, 4, d), p.r_diag, state)
    return y.to(x.dtype), st
