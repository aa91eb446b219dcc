"""The recurrent families, xlstm-350m and zamba2-7b: the port of
`repro.models.recurrent`.

xLSTM: G groups of (slstm_every - 1) mLSTM blocks and one sLSTM block,
each wrapped in an up (d -> 2d) / SiLU-gate / down (d -> d) projection
pair.  The gate half is the DSG site: DRS estimates the gate
pre-activations and masks neuron groups.

Zamba2: G groups of `shared_attn_every` Mamba2 blocks, each followed by
ONE shared attention + SwiGLU block (one set of weights, called G times,
with a K/V cache of its own per call).  DSG sites: the Mamba2 z gate and
the shared block's SwiGLU.

The reference stacks the blocks' leaves as (G, n_m, ...) or (G, every,
...) and scans them; the port holds nested `nn.ModuleList`s (`mlstm[g][l]`,
`mamba[g][e]`) run by Python loops.  Decode states keep the reference's
stacked layout: xLSTM {'m_c': (G, n_m, B, H, Dk, Dv), 'm_n': (G, n_m, B,
H, Dk), 's': {'c', 'n', 'm', 'h'}: (G, B, d)}, Zamba {'ssm': (G, M, B, H,
N, P), 'conv_x', 'conv_bc': (G, M, B, K-1, C), 'k', 'v': (G, B, T, Kv,
D)}.  Each call returns new state tensors, except zamba's K/V, which a
decode step writes in place, as the port's caches are.

Zamba's prefill attends over the prompt alone and returns its K/V, of the
prompt's length P, whatever cache it was given (as `repro.models.api`
does); decode then treats those P slots as a ring: slot pos % P, holding
position pos - ((pos - j) % P) in slot j.

With cfg.remat, a training forward (no state, parameters requiring grad)
recomputes each group in the backward (`torch.utils.checkpoint`), as the
reference's jax.checkpoint of its group body.

Sharded: in a parallel context whose weights are DTensors laid out by the
spec rules (`models.specs`), each block runs as explicit shard_map
bodies on local tensors (`parallel.collectives`), so the time and chunk
loops run on each rank's shard as the reference's partitioned scans do,
and the only collectives are the bodies' own:
  * xLSTM's wrap: w_up column-parallel, its output gathered over 'model'
    (the core reads its input by w_qkv's and w_in's rows, the gate by
    w_down's); the gate and down-projection one body, w_down
    row-parallel with one all-reduce;
  * the mLSTM: w_qkv and w_gates row-parallel (an all-reduce each), the
    chunked scan on every head (xlstm-350m's 4 heads do not split over
    16), w_out row-parallel (an all-reduce);
  * the sLSTM: w_in row-parallel (an all-reduce), its loop over time on
    this rank's channels (the recurrence is diagonal), its state split
    over 'model' by channel;
  * Mamba2: head-parallel, w_z, w_x and conv_x by their columns, the SSD
    scan on this rank's heads, its state split over 'model' by head,
    w_bcdt and conv_bc whole, w_out row-parallel (one all-reduce);
  * each gate-branch DRS mask scored on the rank's columns and
    thresholded as the whole batch's, its groups gathered whole where
    they straddle ranks (`_tp_gate_mask`);
  * zamba's shared block through attention's and the FFN's bodies.
The embedding is vocab-parallel, the logits split over the vocabulary.
The recurrent verbs take no `mesh=`: the layout comes from the arguments,
as in the reference.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import drs, masks, projection
from repro_torch.core import dsg_linear as dl
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import RMSNorm, dense_init, embed_init, \
    norm_init
from repro_torch.models.transformer import embed_tokens, torch_dtype
from repro_torch.parallel import context as pctx


def _gate_mask(x: torch.Tensor, r: torch.Tensor, fw: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """DRS over a gate branch: x (B, S, d) -> the expanded neuron mask
    (B, S, F) in x's dtype, detached."""
    fx = projection.project_rows(r, x)
    mask = drs.drs_mask(fx, fw, cfg.dsg.drs_cfg())
    return drs.expand_mask(masks.freeze(mask), cfg.dsg.block).to(x.dtype)


def _training(model: nn.Module) -> bool:
    return (torch.is_grad_enabled()
            and any(p.requires_grad for p in model.parameters()))


def _remat(cfg: ModelConfig, model: nn.Module, decode: bool) -> bool:
    """Recompute each group in the backward: a training forward only."""
    return cfg.remat and not decode and _training(model)


# ===========================================================================
# tensor-parallel bodies
# ===========================================================================

def _ctx():
    ctx = pctx.current()
    return ctx.mesh, ctx.ax.batch


def _sharded(w: torch.Tensor) -> bool:
    """Whether the block runs as bodies: its weights are DTensors in a
    parallel context (on a model axis of 1 too, where the bodies' loops
    run on the batch shard with no collective)."""
    from repro_torch.parallel.sharding import is_dtensor
    return pctx.current() is not None and is_dtensor(w)


def _tp_gate_mask(h: torch.Tensor, r: torch.Tensor, fw: torch.Tensor,
                  cfg: ModelConfig, mesh, ba) -> torch.Tensor:
    """Inside a body: `_gate_mask` of this rank's columns of a gate
    branch.  h (..., d) replicated over 'model', fw (k, F / model) the
    rank's columns of f(W): the virtual pre-activations of its columns
    scored by group and thresholded as the whole batch's
    (`dsg_linear.select_mask_sharded`); where the groups straddle ranks
    (xlstm-350m's 8 over 16, zamba2-7b's 56 over 16) the virtual
    pre-activations are gathered over 'model' first, every rank selects
    every group and keeps its own columns."""
    from repro_torch.parallel.collectives import (all_gather, axis_index,
                                                  axis_size)
    drs_cfg, block = cfg.dsg.drs_cfg(), cfg.dsg.block
    cols = fw.shape[-1]
    f = cols * axis_size("model", mesh)
    with torch.no_grad():
        virtual = projection.project_rows(r, h) @ fw
        if (f // block) % axis_size("model", mesh) == 0:
            mask = dl.select_mask_sharded(drs.group_scores(virtual, drs_cfg),
                                          f, drs_cfg, mesh, ba)
            return drs.expand_mask(mask, block).to(h.dtype)
        virtual = all_gather(virtual, "model", -1, mesh)
        mask = dl.select_mask_sharded(drs.group_scores(virtual, drs_cfg), f,
                                      drs_cfg, mesh, ba, split=False)
        start = axis_index("model", mesh) * cols
        return drs.expand_mask(mask, block)[..., start:start + cols].to(
            h.dtype)


def _tp_rows(x: torch.Tensor, w: torch.Tensor, f32: bool = False):
    """x (B, S, n) replicated over 'model' times w (n, k) split by rows
    over 'model', as one body: each rank multiplies its own rows' slice
    of x (in f32 with `f32`), the partial products summed over 'model'
    (one all-reduce)."""
    from repro_torch.parallel.collectives import axis_index, psum, shard_map
    from repro_torch.parallel.sharding import P
    mesh, ba = _ctx()

    def body(x_l, w_l):
        n = w_l.shape[0]
        start = axis_index("model", mesh) * n
        x_l = x_l[..., start:start + n]
        if f32:
            x_l, w_l = x_l.float(), w_l.float()
        return psum(x_l @ w_l, "model", mesh)

    return shard_map(body, mesh, (P(ba, None, None), P("model", None)),
                     P(ba, None, None))(x, w)


def _tp_gate_down(y, g, h, w_down, r, fw, cfg: ModelConfig):
    """(y * silu(g) [* the DRS mask]) @ w_down as one body: y and g by
    this rank's columns (w_down's rows), w_down row-parallel, the partial
    products summed over 'model'."""
    from repro_torch.parallel.collectives import psum, shard_map
    from repro_torch.parallel.sharding import P
    mesh, ba = _ctx()

    def body(y_l, g_l, w_l, h_l, r_l, fw_l):
        gate = F.silu(g_l)
        if fw_l is not None:
            gate = gate * _tp_gate_mask(h_l, r_l, fw_l, cfg, mesh, ba)
        return psum((y_l * gate) @ w_l, "model", mesh)

    col, rep = P(ba, None, "model"), P(ba, None, None)
    on = fw is not None
    return shard_map(
        body, mesh,
        (col, col, P("model", None), rep if on else None,
         P() if on else None, P(None, "model") if on else None), rep)(
            y, g, w_down, h if on else None,
            pctx.replicated(r) if on else None,
            pctx.replicated(fw) if on else None)


def _tp_mlstm(p: xl.MLSTM, a, dm: xl.MLSTMDims, state: Optional[dict]):
    """The mLSTM on a (B, S, d) replicated over 'model': its projections
    row-parallel, the core one body computed alike on every rank of
    'model' (the heads do not split), its state replicated over 'model'.
    Returns (out (B, S, d) replicated, {'c', 'n'})."""
    from repro_torch.parallel.collectives import shard_map
    from repro_torch.parallel.sharding import P
    mesh, ba = _ctx()
    qkv = _tp_rows(a, p.w_qkv)
    gates = _tp_rows(a, p.w_gates, f32=True) + p.b_gates

    def body(qkv_l, gates_l, c, n):
        y, st = xl.mlstm_core(qkv_l, gates_l, dm,
                              None if c is None else {"c": c, "n": n})
        return y, st["c"], st["n"]

    rep, sc, sn = P(ba, None, None), P(ba, None, None, None), \
        P(ba, None, None)
    on = state is not None
    y, c, n = shard_map(
        body, mesh, (rep, rep, sc if on else None, sn if on else None),
        (rep, sc, sn), redundant=("model",))(
            qkv, gates, state["c"] if on else None,
            state["n"] if on else None)
    return _tp_rows(y, p.w_out), {"c": c, "n": n}


def _tp_slstm(p: xl.SLSTM, a, state: Optional[dict]):
    """The sLSTM on a (B, S, d) replicated over 'model': w_in
    row-parallel, the loop over time on this rank's channels.  Returns
    (y (B, S, d) in a's dtype and its state (B, d) f32, both split over
    'model' by channel)."""
    from repro_torch.parallel.collectives import (axis_index, axis_size,
                                                  shard_map)
    from repro_torch.parallel.sharding import P
    mesh, ba = _ctx()
    pre = _tp_rows(a, p.w_in, f32=True) + p.bias
    names = ("c", "n", "m", "h")

    def body(pre_l, r_diag, *st):
        b, s, d4 = pre_l.shape
        d = d4 // 4
        cols = d // axis_size("model", mesh)
        start = axis_index("model", mesh) * cols
        y, new = xl.slstm_scan(
            pre_l.view(b, s, 4, d)[..., start:start + cols],
            r_diag[:, start:start + cols],
            None if st[0] is None else dict(zip(names, st)))
        return (y.to(a.dtype), *(new[k] for k in names))

    sst = P(ba, "model")
    on = state is not None
    y, *new = shard_map(
        body, mesh, (P(ba, None, None), P()) + (sst if on else None,) * 4,
        (P(ba, None, "model"),) + (sst,) * 4)(
            pre, p.r_diag, *((state[k] for k in names) if on
                             else (None,) * 4))
    return y, dict(zip(names, new))


def _tp_wrapped(wrap: "Wrap", core, x, r, fw, cfg: ModelConfig,
                dm: xl.MLSTMDims, state: Optional[dict]):
    """`_wrapped_block` on DTensor weights: the up-projection
    column-parallel and gathered over 'model', the core (`_tp_mlstm` or
    `_tp_slstm`), then `_tp_gate_down`."""
    _, ba = _ctx()
    h = wrap.ln(x)
    up = pctx.constrain(h @ wrap.w_up, ba, None, None)
    a, g = up.chunk(2, dim=-1)
    if isinstance(core, xl.MLSTM):
        y, new_state = _tp_mlstm(core, a, dm, state)
    else:
        y, new_state = _tp_slstm(core, a, state)
    return x + _tp_gate_down(y, g, h, wrap.w_down, r, fw, cfg), new_state


def _tp_mamba(blk: "MambaBlock", x, dm: m2.Mamba2Dims, state, r, fw,
              cfg: ModelConfig):
    """A Mamba2 block on DTensor weights as one body, head-parallel: this
    rank's columns of w_z, w_x and conv_x, its heads of the SSD scan and
    of the state, w_bcdt and conv_bc whole, w_out row-parallel with one
    all-reduce.  Returns (y (B, S, d) replicated, the state: 'ssm' split
    over 'model' by head, 'conv_x' by channel, 'conv_bc' replicated)."""
    from repro_torch.parallel.collectives import (axis_index, psum,
                                                  shard_map)
    from repro_torch.parallel.sharding import P
    mesh, ba = _ctx()
    p = blk.mamba
    h = blk.ln(x)

    def body(h_l, w_z, w_x, w_bcdt, conv_x, conv_bc, a_log, dt_bias, d_skip,
             w_out, r_l, fw_l, ssm, cx, cbc):
        n_l = w_z.shape[1] // dm.head_dim
        heads = slice(axis_index("model", mesh) * n_l,
                      (axis_index("model", mesh) + 1) * n_l)
        gmask = (None if fw_l is None else
                 _tp_gate_mask(h_l, r_l, fw_l, cfg, mesh, ba))
        local = SimpleNamespace(w_z=w_z, w_x=w_x, w_bcdt=w_bcdt,
                                conv_x=conv_x, conv_bc=conv_bc, a_log=a_log,
                                dt_bias=dt_bias, d_skip=d_skip, w_out=w_out)
        st = None if ssm is None else {"ssm": ssm, "conv_x": cx,
                                       "conv_bc": cbc}
        y, new = m2.mamba2_forward(local, h_l, dm, st, gmask, heads=heads)
        return (psum(y, "model", mesh), new["ssm"], new["conv_x"],
                new["conv_bc"])

    rep, col = P(ba, None, None), P(None, "model")
    s_ssm, s_cx = P(ba, "model", None, None), P(ba, None, "model")
    on, dsg_on = state is not None, fw is not None
    y, ssm, cx, cbc = shard_map(
        body, mesh,
        (rep, col, col, P(), col, P(), P(), P(), P(), P("model", None),
         P() if dsg_on else None, col if dsg_on else None,
         s_ssm if on else None, s_cx if on else None, rep if on else None),
        (rep, s_ssm, s_cx, rep))(
            h, p.w_z, p.w_x, p.w_bcdt, p.conv_x, p.conv_bc, p.a_log,
            p.dt_bias, p.d_skip, p.w_out,
            pctx.replicated(r) if dsg_on else None,
            pctx.replicated(fw) if dsg_on else None,
            *((state[k] for k in ("ssm", "conv_x", "conv_bc")) if on
              else (None,) * 3))
    return y, {"ssm": ssm, "conv_x": cx, "conv_bc": cbc}


def _head(model: nn.Module, x: torch.Tensor, last_only: bool):
    x = model.ln_final(x)
    if last_only:
        x = x[:, -1:]
    return x @ model.lm_head


# ===========================================================================
# xLSTM
# ===========================================================================

def _xlstm_groups(cfg: ModelConfig):
    """(groups, mLSTM blocks a group, whether each group ends in an
    sLSTM block)."""
    every = cfg.slstm_every or cfg.n_layers
    n_m = every - 1 if cfg.slstm_every else cfg.n_layers
    groups = max(1, cfg.n_layers // max(every, 1))
    return groups, n_m, bool(cfg.slstm_every)


class Wrap(nn.Module):
    """Pre-norm, w_up (d, 2d) and w_down (d, d) around a core."""

    def __init__(self, ln: RMSNorm, w_up: torch.Tensor, w_down: torch.Tensor):
        super().__init__()
        self.ln = ln
        self.w_up = nn.Parameter(w_up, requires_grad=False)
        self.w_down = nn.Parameter(w_down, requires_grad=False)


class XLSTMBlock(nn.Module):
    def __init__(self, wrap: Wrap, core: nn.Module):
        super().__init__()
        self.wrap = wrap
        self.core = core


class XLSTMModel(nn.Module):
    def __init__(self, embed, mlstm, slstm, ln_final, lm_head):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)      # (V, d)
        self.mlstm = nn.ModuleList(nn.ModuleList(g) for g in mlstm)
        self.slstm = nn.ModuleList(slstm) if slstm is not None else None
        self.ln_final = ln_final
        self.lm_head = nn.Parameter(lm_head, requires_grad=False)  # (d, V)


def _init_wrap(d, kw) -> Wrap:
    return Wrap(norm_init(d, dtype=kw["dtype"], device=kw["device"]),
                dense_init((d, 2 * d), d, **kw), dense_init((d, d), d, **kw))


def _lm_head(cfg, kw):
    return (torch.randn((cfg.d_model, cfg.vocab), generator=kw["generator"],
                        device=kw["device"])
            / math.sqrt(cfg.d_model)).to(kw["dtype"])


def init_xlstm_model(cfg: ModelConfig, *,
                     generator: Optional[torch.Generator],
                     device=None) -> XLSTMModel:
    """Random weights from `generator` (created on `device`), with the
    reference's scales and dtypes."""
    kw = dict(generator=generator, dtype=torch_dtype(cfg), device=device)
    groups, n_m, has_s = _xlstm_groups(cfg)
    dm = xl.mlstm_dims(cfg.d_model, cfg.n_heads)
    embed = embed_init(cfg.vocab, cfg.d_model, **kw)
    mlstm = [[XLSTMBlock(_init_wrap(cfg.d_model, kw), xl.init_mlstm(dm, **kw))
              for _ in range(n_m)] for _ in range(groups)]
    slstm = ([XLSTMBlock(_init_wrap(cfg.d_model, kw),
                         xl.init_slstm(cfg.d_model, **kw))
              for _ in range(groups)] if has_s else None)
    return XLSTMModel(embed, mlstm, slstm,
                      norm_init(cfg.d_model, dtype=kw["dtype"],
                                device=device), _lm_head(cfg, kw))


def _gate_fw(r: torch.Tensor, blk: XLSTMBlock, d: int) -> torch.Tensor:
    """f(W) of a block's gate half, the last d columns of w_up: (k, d)."""
    return r @ blk.wrap.w_up[:, d:]


def _xlstm_fw(r: torch.Tensor, model: XLSTMModel, cfg: ModelConfig,
              with_s: bool) -> dict:
    d = cfg.d_model
    with torch.no_grad():
        out = {"r": r, "fw_m": torch.stack([torch.stack(
            [_gate_fw(r, blk, d) for blk in g]) for g in model.mlstm])}
        if with_s:
            out["fw_s"] = torch.stack([_gate_fw(r, blk, d)
                                       for blk in model.slstm])
    return out


def init_xlstm_dsg(model: XLSTMModel, cfg: ModelConfig, *,
                   generator: torch.Generator, device=None):
    if not cfg.dsg.enabled:
        return None
    d = cfg.d_model
    r = projection.make_projection(dl.proj_dim(d, d, cfg.dsg), d,
                                   generator=generator,
                                   dtype=torch_dtype(cfg), device=device)
    return _xlstm_fw(r, model, cfg, model.slstm is not None)


def refresh_xlstm_dsg(dsg: Optional[dict], model: XLSTMModel,
                      cfg: ModelConfig) -> Optional[dict]:
    """f(W) of every block's gate half recomputed from the current
    weights: fw_m (G, n_m, k, d), and fw_s (G, k, d) where the DSG state
    has sLSTM blocks; R is kept.  Not differentiated."""
    if dsg is None:
        return None
    return _xlstm_fw(dsg["r"], model, cfg, "fw_s" in dsg)


def _wrapped_block(wrap: Wrap, core_apply, x, r, fw, cfg: ModelConfig):
    """pre-norm -> up -> core(a) * silu-gate(g) -> down -> residual."""
    h = wrap.ln(x)
    a, g = (h @ wrap.w_up).chunk(2, dim=-1)
    y, new_state = core_apply(a)
    gate = F.silu(g)
    if fw is not None:
        gate = gate * _gate_mask(h, r, fw, cfg)
    return x + (y * gate) @ wrap.w_down, new_state


def _xlstm_block(blk: XLSTMBlock, x, r, fw, cfg: ModelConfig,
                 dm: xl.MLSTMDims, state: Optional[dict]):
    """One wrapped mLSTM or sLSTM block; as bodies on DTensor weights."""
    if _sharded(blk.wrap.w_up):
        return _tp_wrapped(blk.wrap, blk.core, x, r, fw, cfg, dm, state)
    if isinstance(blk.core, xl.MLSTM):
        return _wrapped_block(blk.wrap, lambda a: xl.mlstm_forward(
            blk.core, a, dm, state), x, r, fw, cfg)
    return _wrapped_block(blk.wrap, lambda a: xl.slstm_forward(
        blk.core, a, state), x, r, fw, cfg)


def _xlstm_group(x, m_blocks, s_block, cfg, dm, r, fw_m, fw_s, mc, mn,
                 s_state):
    """One group: its mLSTM blocks, then its sLSTM block.  Returns (x,
    [c], [n], new sLSTM state).  mc / mn None: the mLSTM states start at
    (0, 1)."""
    cs, ns = [], []
    for l, blk in enumerate(m_blocks):
        x, st = _xlstm_block(blk, x, r, None if fw_m is None else fw_m[l],
                             cfg, dm,
                             None if mc is None else {"c": mc[l],
                                                      "n": mn[l]})
        cs.append(st["c"])
        ns.append(st["n"])
    if s_block is not None:
        x, s_state = _xlstm_block(s_block, x, r, fw_s, cfg, dm, s_state)
    return x, cs, ns, s_state


def xlstm_forward(model: XLSTMModel, dsg: Optional[dict], cfg: ModelConfig,
                  tokens: torch.Tensor, state: Optional[dict] = None,
                  last_only: bool = False):
    """tokens (B, S) -> (logits, new_state).  With no state the mLSTM
    states start at (0, 1) and the sLSTM's at c = m = h = 0, n = 1 (made
    here for one token, which then takes the one-step recurrence, as the
    reference's zero state does)."""
    groups, n_m, has_s = _xlstm_groups(cfg)
    dm = xl.mlstm_dims(cfg.d_model, cfg.n_heads)
    x = embed_tokens(model.embed, tokens)
    r = dsg["r"] if dsg else None
    if state is None and tokens.shape[1] == 1:
        b = x.shape[0]
        f32 = dict(dtype=torch.float32, device=x.device)
        state = {"m_c": torch.zeros((groups, n_m, b, dm.heads, dm.dk, dm.dv),
                                    **f32),
                 "m_n": torch.ones((groups, n_m, b, dm.heads, dm.dk), **f32)}
        if has_s:
            zs = torch.zeros((groups, b, cfg.d_model), **f32)
            state["s"] = {"c": zs, "n": zs + 1.0, "m": zs, "h": zs}
    remat = _remat(cfg, model, decode=False)
    mcs, mns, ss = [], [], []
    for g in range(groups):
        args = (x, model.mlstm[g], model.slstm[g] if has_s else None, cfg,
                dm, r, dsg["fw_m"][g] if dsg else None,
                dsg["fw_s"][g] if dsg and "fw_s" in dsg else None,
                state["m_c"][g] if state else None,
                state["m_n"][g] if state else None,
                {k: v[g] for k, v in state["s"].items()}
                if has_s and state else None)
        if remat:
            x, cs, ns, s_new = checkpoint(_xlstm_group, *args,
                                          use_reentrant=False)
        else:
            x, cs, ns, s_new = _xlstm_group(*args)
        mcs.append(torch.stack(cs))
        mns.append(torch.stack(ns))
        ss.append(s_new)
    new_state = {"m_c": torch.stack(mcs), "m_n": torch.stack(mns)}
    if has_s:
        new_state["s"] = {k: torch.stack([s[k] for s in ss])
                          for k in ("c", "n", "m", "h")}
    return _head(model, x, last_only), new_state


# ===========================================================================
# Zamba2
# ===========================================================================

def _mamba_dims(cfg: ModelConfig) -> m2.Mamba2Dims:
    return m2.dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_state, cfg.ssm_heads,
                   cfg.ssm_chunk)


class MambaBlock(nn.Module):
    def __init__(self, ln: RMSNorm, mamba: m2.Mamba2):
        super().__init__()
        self.ln = ln
        self.mamba = mamba


class SharedBlock(nn.Module):
    """The one attention + SwiGLU block every group calls."""

    def __init__(self, ln_attn: RMSNorm, attn_p: attn.Attention,
                 ln_ffn: RMSNorm, ffn: dl.SwiGLU):
        super().__init__()
        self.ln_attn = ln_attn
        self.attn = attn_p
        self.ln_ffn = ln_ffn
        self.ffn = ffn


class ZambaModel(nn.Module):
    def __init__(self, embed, mamba, shared: SharedBlock, ln_final,
                 lm_head):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)      # (V, d)
        self.mamba = nn.ModuleList(nn.ModuleList(g) for g in mamba)
        self.shared = shared
        self.ln_final = ln_final
        self.lm_head = nn.Parameter(lm_head, requires_grad=False)  # (d, V)


def _zamba_groups(cfg: ModelConfig):
    every = cfg.shared_attn_every
    return cfg.n_layers // every, every


def init_zamba_model(cfg: ModelConfig, *,
                     generator: Optional[torch.Generator],
                     device=None) -> ZambaModel:
    dt = torch_dtype(cfg)
    kw = dict(generator=generator, dtype=dt, device=device)
    dm = _mamba_dims(cfg)
    groups, every = _zamba_groups(cfg)
    embed = embed_init(cfg.vocab, cfg.d_model, **kw)
    mamba = [[MambaBlock(norm_init(cfg.d_model, dtype=dt, device=device),
                         m2.init_mamba2(dm, **kw))
              for _ in range(every)] for _ in range(groups)]
    shared = SharedBlock(
        norm_init(cfg.d_model, dtype=dt, device=device),
        attn.init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv,
                            cfg.head_dim, **kw),
        norm_init(cfg.d_model, dtype=dt, device=device),
        dl.init_swiglu(cfg.d_model, cfg.d_ff, **kw))
    return ZambaModel(embed, mamba, shared,
                      norm_init(cfg.d_model, dtype=dt, device=device),
                      _lm_head(cfg, kw))


def init_zamba_dsg(model: ZambaModel, cfg: ModelConfig, *,
                   generator: torch.Generator, device=None):
    if not cfg.dsg.enabled:
        return None
    k = dl.proj_dim(cfg.d_model, _mamba_dims(cfg).d_in, cfg.dsg)
    r = projection.make_projection(k, cfg.d_model, generator=generator,
                                   dtype=torch_dtype(cfg), device=device)
    return refresh_zamba_dsg({"r": r}, model, cfg)


def refresh_zamba_dsg(dsg: Optional[dict], model: ZambaModel,
                      cfg: ModelConfig) -> Optional[dict]:
    """f(W) recomputed from the current weights: fw_z (G, every, k, d_in)
    of each Mamba2 z projection, fw_shared (k, F) of the shared SwiGLU's
    gate; R is kept.  Not differentiated."""
    if dsg is None:
        return None
    r = dsg["r"]
    with torch.no_grad():
        return {"r": r,
                "fw_z": torch.stack([torch.stack(
                    [r @ blk.mamba.w_z for blk in g]) for g in model.mamba]),
                "fw_shared": r @ model.shared.ffn.w_gate}


def _zamba_group(x, blocks, shared, cfg, dm, r, fw_z, fw_sh, q_pos, pos0,
                 decode, ssm, cx, cbc, kv, kv_out):
    """One group: its Mamba2 blocks, then the shared block.  Returns (x,
    [ssm], [conv_x], [conv_bc], this call's K/V; None from the sharded
    attention unless `kv_out`)."""
    ssms, cxs, cbcs = [], [], []
    for e, blk in enumerate(blocks):
        st = ({"ssm": ssm[e], "conv_x": cx[e], "conv_bc": cbc[e]}
              if decode else None)
        fw = None if fw_z is None else fw_z[e]
        if _sharded(blk.mamba.w_z):
            y, new = _tp_mamba(blk, x, dm, st, r, fw, cfg)
        else:
            h = blk.ln(x)
            gmask = None if fw is None else _gate_mask(h, r, fw, cfg)
            y, new = m2.mamba2_forward(blk.mamba, h, dm, st, gmask)
        x = x + y
        ssms.append(new["ssm"])
        cxs.append(new["conv_x"])
        cbcs.append(new["conv_bc"])
    h = shared.ln_attn(x)
    cache_pos, cache_kv_pos = pos0, None
    if decode:
        w = kv["k"].shape[1]
        slots = torch.arange(w, device=x.device)
        if cfg.window:
            # the prefill's P slots as a ring: slot pos % P holds pos
            cache_pos = pos0 % w
            cache_kv_pos = pos0 - ((pos0 - slots) % w)
        else:
            cache_kv_pos = slots
    a, kv_new = attn.self_attention(
        shared.attn, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        rope_theta=cfg.rope_theta, q_pos=q_pos, causal=True,
        window=cfg.window, cache=kv if decode else None,
        cache_pos=cache_pos, cache_kv_pos=cache_kv_pos, kv_out=kv_out)
    x = x + a
    h = shared.ln_ffn(x)
    st = {"r": r, "fw": fw_sh} if fw_sh is not None else None
    x = x + dl.swiglu_ffn(shared.ffn, h, st, cfg.dsg)
    return x, ssms, cxs, cbcs, kv_new


def zamba_forward(model: ZambaModel, dsg: Optional[dict], cfg: ModelConfig,
                  tokens: torch.Tensor, state: Optional[dict] = None,
                  pos0=0, last_only: bool = False):
    """tokens (B, S) -> (logits, new_state).  state None: a training or
    prefill forward from zero states, whose shared attention attends over
    the S tokens and returns their K/V (a sharded training forward
    returns no K/V); else a decode step at position pos0 (an int, or a
    0-dim tensor) over the state's K/V slots."""
    dm = _mamba_dims(cfg)
    groups, _ = _zamba_groups(cfg)
    x = embed_tokens(model.embed, tokens)
    s = x.shape[1]
    q_pos = pos0 + torch.arange(s, device=x.device)
    r = dsg["r"] if dsg else None
    fw_sh = dsg["fw_shared"] if dsg else None
    decode = state is not None
    remat = _remat(cfg, model, decode)
    out = {"ssm": [], "conv_x": [], "conv_bc": [], "k": [], "v": []}
    for g in range(groups):
        kv = ({"k": state["k"][g], "v": state["v"][g]} if decode else None)
        args = (x, model.mamba[g], model.shared, cfg, dm, r,
                dsg["fw_z"][g] if dsg else None, fw_sh, q_pos, pos0, decode,
                *((state[n][g] for n in ("ssm", "conv_x", "conv_bc"))
                  if decode else (None, None, None)), kv,
                not decode and not _training(model))
        if remat:
            x, ssms, cxs, cbcs, kv_new = checkpoint(_zamba_group, *args,
                                                    use_reentrant=False)
        else:
            x, ssms, cxs, cbcs, kv_new = _zamba_group(*args)
        for name, ts in (("ssm", ssms), ("conv_x", cxs), ("conv_bc", cbcs)):
            out[name].append(torch.stack(ts))
        if kv_new is not None:
            out["k"].append(kv_new["k"])
            out["v"].append(kv_new["v"])
    new_state = {n: torch.stack(ts) for n, ts in out.items()
                 if n not in ("k", "v")}
    if decode:
        # written in place through the per-group views
        new_state.update(k=state["k"], v=state["v"])
    elif out["k"]:
        new_state.update(k=torch.stack(out["k"]), v=torch.stack(out["v"]))
    return _head(model, x, last_only), new_state


def init_zamba_cache(cfg: ModelConfig, batch: int, max_seq: int,
                     dtype: torch.dtype, device=None) -> dict:
    """The reference's decode state at zero: SSM states f32, conv states
    and K/V (min(max_seq, window) slots with a window) in `dtype`."""
    dm = _mamba_dims(cfg)
    groups, every = _zamba_groups(cfg)
    kv_len = min(max_seq, cfg.window) if cfg.window else max_seq
    conv = (groups, every, batch, m2.CONV_K - 1)
    kv = (groups, batch, kv_len, cfg.n_kv, cfg.head_dim)
    return {
        "ssm": torch.zeros((groups, every, batch, dm.heads, dm.n,
                            dm.head_dim), dtype=torch.float32,
                           device=device),
        "conv_x": torch.zeros(conv + (dm.d_in,), dtype=dtype, device=device),
        "conv_bc": torch.zeros(conv + (2 * dm.n,), dtype=dtype,
                               device=device),
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device)}
