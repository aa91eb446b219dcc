"""DSG-sparsified SwiGLU and GELU FFNs (the port of
`repro.core.dsg_linear`).

Weights keep the reference layout: w_gate/w_up (d, F), w_down (F, d); the
DSG group dim is F split into G = F/block groups.  The GELU FFN
(whisper's; `gelu_ffn`) has no gate and runs its DRS search against w_up,
in the same three modes as `swiglu_ffn` (dense, mask, gather_shared), with
the tanh GELU of the reference's `jax.nn.gelu`.  The SwiGLU paths:

  * `swiglu_dense`      — no DSG.
  * `swiglu_dsg_mask`   — paper-faithful per-token mask: DRS selects groups
                          online, the full products run, the mask zeroes the
                          dropped groups (training, prefill, and decode
                          without the serving runtime).  The mask is
                          detached, so the backward error through a dropped
                          group is exactly zero (the paper's Algorithm 1).
  * `swiglu_dsg_gather` — one selection shared by every token of the batch
                          (batch-summed group scores, per-chunk top-k); only
                          the kept groups' weight blocks are gathered and
                          multiplied (`mode="gather_shared"`).
  * `swiglu_dsg_gather_sharded` — the same under tensor parallelism: each
                          'model' shard selects among and gathers its own
                          groups (`mode="gather_shared"` inside a parallel
                          context whose model axis divides F in blocks).
  * `swiglu_csr_masked` — the masked-dense reference for per-lane
                          group-CSR patterns.
  * `swiglu_csr`        — serving decode over per-lane group-CSR patterns
                          through the group-CSR kernel (`kernels/dsg_ffn.py`),
                          which reads only the listed groups' weight blocks.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import drs, masks, projection, sparse_mask
from repro_torch.parallel import context as pctx


class DSGConfig(NamedTuple):
    enabled: bool = False
    gamma: float = 0.5            # fraction of neuron groups dropped
    eps: float = 0.5              # JLL epsilon -> projection dim k
    block: int = 128              # neuron-group width
    threshold_mode: str = "topk"  # "topk" | "shared" | "ema"
    score: str = "relu_sum"
    mode: str = "mask"            # "mask" | "gather_shared"
    n_chunks: int = 1             # balanced per-chunk selection
    refresh_every: int = 50

    def drs_cfg(self) -> drs.DRSConfig:
        return drs.DRSConfig(gamma=self.gamma, block=self.block,
                             threshold_mode=self.threshold_mode,
                             score=self.score)


def proj_dim(d: int, n_out: int, cfg: DSGConfig) -> int:
    return projection.jll_dim(d, n_points=n_out + 1, eps=cfg.eps)


class SwiGLU(nn.Module):
    """SwiGLU FFN weights: w_gate/w_up (d, F), w_down (F, d)."""

    def __init__(self, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor):
        super().__init__()
        self.w_gate = nn.Parameter(w_gate, requires_grad=False)
        self.w_up = nn.Parameter(w_up, requires_grad=False)
        self.w_down = nn.Parameter(w_down, requires_grad=False)


def init_swiglu(d: int, f: int, *, generator: torch.Generator,
                dtype: torch.dtype, device=None) -> SwiGLU:
    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)
    return SwiGLU(normal((d, f), 1.0 / math.sqrt(d)),
                  normal((d, f), 1.0 / math.sqrt(d)),
                  normal((f, d), 1.0 / math.sqrt(f)))


class GeluFFN(nn.Module):
    """GELU FFN weights: w_up (d, F), w_down (F, d)."""

    def __init__(self, w_up: torch.Tensor, w_down: torch.Tensor):
        super().__init__()
        self.w_up = nn.Parameter(w_up, requires_grad=False)
        self.w_down = nn.Parameter(w_down, requires_grad=False)


def init_gelu_ffn(d: int, f: int, *, generator: torch.Generator,
                  dtype: torch.dtype, device=None) -> GeluFFN:
    def normal(shape, fan):
        return (torch.randn(shape, generator=generator, device=device)
                / math.sqrt(fan)).to(dtype)
    return GeluFFN(normal((d, f), d), normal((f, d), f))


def search_weight(p) -> torch.Tensor:
    """The weight DRS estimates against: the gate path if there is one
    (its SiLU argument decides the activation's magnitude), else the up
    path."""
    return p.w_gate if hasattr(p, "w_gate") else p.w_up


def init_dsg_state(d: int, f: int, cfg: DSGConfig, w_search: torch.Tensor,
                   *, generator: torch.Generator,
                   dtype: torch.dtype = torch.float32, device=None) -> dict:
    """DSG buffers of one layer: the projection R (k, d) and the projected
    search weights f(W) = R @ w_search (k, f), refreshed by the training
    loop every cfg.refresh_every steps (`refresh_fw`)."""
    r = projection.make_projection(proj_dim(d, f, cfg), d,
                                   generator=generator, dtype=dtype,
                                   device=device)
    with torch.no_grad():
        return {"r": r, "fw": projection.project(r, w_search.to(dtype))}


def refresh_fw(state: dict, w_search: torch.Tensor) -> dict:
    with torch.no_grad():
        return {"r": state["r"], "fw": projection.project(
            state["r"], w_search.to(state["r"].dtype))}


def drs_group_mask(x: torch.Tensor, state: dict,
                   cfg: DSGConfig) -> torch.Tensor:
    """Per-token group mask (..., G) from the dimension-reduction search."""
    fx = projection.project_rows(state["r"], x)
    return masks.freeze(drs.drs_mask(fx, state["fw"], cfg.drs_cfg()))


def shared_topk_indices(x: torch.Tensor, state: dict, cfg: DSGConfig,
                        f: int) -> torch.Tensor:
    """Batch-shared selection ("gather_shared"): group scores summed over
    every token row, then a top-k in each of `n_chunks` contiguous chunks
    of the groups (one chunk when they do not divide G).  Returns the kept
    group indices (K',), ascending."""
    fx = projection.project_rows(state["r"], x)
    scores = drs.group_scores(fx @ state["fw"], cfg.drs_cfg())
    scores = scores.reshape(-1, scores.shape[-1]).sum(dim=0)     # (G,)
    g = scores.shape[0]
    keep_total = drs.keep_groups(f, cfg.drs_cfg())
    n_chunks = max(1, cfg.n_chunks)
    if g % n_chunks != 0:
        n_chunks = 1
    per_chunk = max(1, keep_total // n_chunks)
    local = torch.topk(scores.reshape(n_chunks, g // n_chunks), per_chunk,
                       dim=-1).indices                            # (C, kc)
    base = (torch.arange(n_chunks, device=x.device) * (g // n_chunks))
    return torch.sort((local + base[:, None]).reshape(-1)).values.detach()


def _gather_blocks(p, idx: torch.Tensor, block: int):
    """The kept groups' (K', d, b) blocks of w_up and (K', b, d) of
    w_down."""
    d, f = p.w_up.shape
    wu = p.w_up.reshape(d, f // block, block).transpose(0, 1)[idx]
    wd = p.w_down.reshape(f // block, block, d)[idx]
    return wu, wd


def _gate_up(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return F.silu(x @ p.w_gate) * (x @ p.w_up)


def swiglu_dense(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return _gate_up(p, x) @ p.w_down


def swiglu_dsg_mask(p: SwiGLU, x: torch.Tensor, state: dict,
                    cfg: DSGConfig) -> torch.Tensor:
    """Paper-faithful per-token masked SwiGLU: dropped groups are zeroed
    after the nonlinearity."""
    mask = drs_group_mask(x, state, cfg)
    h = masks.apply_expanded(_gate_up(p, x), mask, cfg.block)
    return h @ p.w_down


def swiglu_dsg_gather(p: SwiGLU, x: torch.Tensor, state: dict,
                      cfg: DSGConfig) -> torch.Tensor:
    """Batch-shared gathered SwiGLU: only the kept groups' columns of
    w_gate/w_up and rows of w_down are multiplied, (1 - gamma) of the
    dense products."""
    d, f = p.w_gate.shape
    b = cfg.block
    idx = shared_topk_indices(x, state, cfg, f)                  # (K',)
    wg = p.w_gate.reshape(d, f // b, b).transpose(0, 1)[idx]     # (K', d, b)
    wu, wd = _gather_blocks(p, idx, b)
    h = (F.silu(torch.einsum("...d,kdb->...kb", x, wg))
         * torch.einsum("...d,kdb->...kb", x, wu))
    return torch.einsum("...kb,kbd->...d", h, wd)


def swiglu_dsg_gather_sharded(p: SwiGLU, x: torch.Tensor, state: dict,
                              cfg: DSGConfig) -> torch.Tensor:
    """gather_shared under tensor parallelism, inside a shard_map over the
    parallel context's mesh: each 'model' shard scores its own groups
    (summed over its rows of the batch), keeps the top
    ceil((1 - gamma) · G_local) of them (ties to the lower group, as
    lax.top_k's), gathers its own weight blocks, and the shards' outputs
    are summed over 'model'.  No weight crosses a shard; the selection is
    balanced per shard (n_chunks = shards)."""
    from repro_torch.parallel.collectives import psum, shard_map
    from repro_torch.parallel.sharding import P

    ctx = pctx.current()
    mesh, ba = ctx.mesh, ctx.ax.batch
    d = p.w_gate.shape[0]
    blk = cfg.block
    drs_cfg = cfg.drs_cfg()

    def body(x_l, wg, wu, wd, r, fw):
        g_loc = wg.shape[1] // blk
        keep = max(1, int((1.0 - cfg.gamma) * g_loc + 0.999999))
        fx = projection.project_rows(r, x_l)
        scores = drs.group_scores(fx @ fw, drs_cfg)
        scores = scores.reshape(-1, g_loc).sum(dim=0)              # (G_loc,)
        idx = torch.sort(scores.detach(), descending=True,
                         stable=True).indices[:keep]
        idx = torch.sort(idx).values
        wg3 = wg.reshape(d, g_loc, blk).transpose(0, 1)[idx]       # (K, d, b)
        wu3 = wu.reshape(d, g_loc, blk).transpose(0, 1)[idx]
        wd3 = wd.reshape(g_loc, blk, d)[idx]                       # (K, b, d)
        h = (F.silu(torch.einsum("...d,kdb->...kb", x_l, wg3))
             * torch.einsum("...d,kdb->...kb", x_l, wu3))
        return psum(torch.einsum("...kb,kbd->...d", h, wd3), "model", mesh)

    nd = (None,) * (x.ndim - 1)
    return shard_map(
        body, mesh,
        (P(ba, *nd), P(None, "model"), P(None, "model"), P("model", None),
         P(), P(None, "model")),
        P(ba, *nd))(x, p.w_gate, p.w_up, p.w_down, state["r"], state["fw"])


def select_mask_sharded(scores: torch.Tensor, n_out: int,
                        cfg: drs.DRSConfig, mesh, batch_axes,
                        split: bool = True) -> torch.Tensor:
    """`drs.select_mask` inside a shard_map body whose rank holds the
    rows of its batch shard, and (`split`) the groups of its 'model'
    shard, (..., G / model), else every group: the same threshold as the
    whole batch's, read from the scores gathered over 'model' (per row
    for "topk"; row 0 of the flattened batch, from the batch shard that
    holds it, for "shared"; the mean over every batch shard's rows for
    "ema"), applied to the rank's scores."""
    from repro_torch.parallel.collectives import (all_gather, axis_index,
                                                  axis_size, psum)
    k = drs.keep_groups(n_out, cfg)
    if k >= n_out // cfg.block:
        return torch.ones_like(scores, dtype=torch.float32)

    def whole(t):
        return all_gather(t, "model", -1, mesh) if split else t
    ba = tuple(batch_axes or ())
    if cfg.threshold_mode == "shared":
        row = scores.reshape(-1, scores.shape[-1])[0:1]
        if not all(axis_index(a, mesh) == 0 for a in ba):
            row = torch.zeros_like(row)
        for a in ba:
            row = psum(row, a, mesh)
        thr = drs._topk_threshold(whole(row), k)
        thr = thr.reshape((1,) * scores.ndim)
    elif cfg.threshold_mode in ("topk", "ema"):
        thr = drs._topk_threshold(whole(scores), k)
        if cfg.threshold_mode == "ema":
            total, rows = thr.to(torch.float32).sum(), thr.numel()
            for a in ba:
                total = psum(total, a, mesh)
                rows *= axis_size(a, mesh)
            thr = total / rows
    else:
        raise ValueError(f"unknown threshold_mode {cfg.threshold_mode}")
    return (scores >= thr).to(torch.float32)


def _tp_ffn(p, x: torch.Tensor, state: Optional[dict], cfg: DSGConfig,
            act: str) -> torch.Tensor:
    """The SwiGLU (act "swiglu") or GELU FFN, dense or DSG-masked, under
    tensor parallelism as one shard_map body: gate/up column-parallel
    (each rank's own F / model hidden columns from its input, replicated
    over 'model'), down row-parallel, the partial outputs summed over
    'model' (one all-reduce).  The DRS mask is scored on each rank's own
    groups and thresholded as the whole batch's (`select_mask_sharded`);
    where the groups do not divide the axis (deepseek-moe-16b's 22
    shared-expert groups, whisper-large-v3's 40, over 16), the virtual
    pre-activations f(x) f(W) of each rank's columns are gathered over
    'model' and every rank selects every group, then keeps its own
    columns.  No weight crosses a rank."""
    from repro_torch.parallel.collectives import (all_gather, axis_index,
                                                  psum, shard_map)
    from repro_torch.parallel.sharding import P
    ctx = pctx.current()
    mesh, ba = ctx.mesh, ctx.ax.batch
    f = p.w_up.shape[1]
    whole = (f // cfg.block) % ctx.n_model == 0
    drs_cfg = cfg.drs_cfg()

    def body(x_l, wu, wd, wg, r, fw):
        up = x_l @ wu
        h = gelu(up) if wg is None else F.silu(x_l @ wg) * up
        if fw is not None:
            with torch.no_grad():
                virtual = projection.project_rows(r, x_l) @ fw
                if whole:
                    mask = select_mask_sharded(
                        drs.group_scores(virtual, drs_cfg), f, drs_cfg,
                        mesh, ba)
                else:
                    virtual = all_gather(virtual, "model", -1, mesh)
                    start = axis_index("model", mesh) * h.shape[-1]
                    mask = drs.expand_mask(select_mask_sharded(
                        drs.group_scores(virtual, drs_cfg), f, drs_cfg,
                        mesh, ba, split=False),
                        cfg.block)[..., start:start + h.shape[-1]]
            if whole:
                h = masks.apply_expanded(h, masks.freeze(mask), cfg.block)
            else:
                h = h * mask.to(h.dtype)
        return psum(h @ wd, "model", mesh)

    nd = (None,) * (x.ndim - 1)
    col = P(None, "model")
    wg = p.w_gate if act == "swiglu" else None
    r = fw = None
    if state is not None:
        r, fw = pctx.replicated(state["r"]), pctx.replicated(state["fw"])
    return shard_map(
        body, mesh,
        (P(ba, *nd, None), col, P("model", None),
         None if wg is None else col, None if r is None else P(),
         None if fw is None else col),
        P(ba, *nd, None))(pctx.replicated(x), p.w_up, p.w_down, wg, r, fw)


FFN_MODES = ("dense", "mask", "gather_shared")
_calls = dict.fromkeys(FFN_MODES, 0)


def swiglu_ffn(p: SwiGLU, x: torch.Tensor, state: Optional[dict],
               cfg: DSGConfig) -> torch.Tensor:
    """The FFN by DSG mode.  `swiglu_ffn.calls` counts the calls of each
    mode (a layer recomputed under remat counts again); set the counts to
    0 with `swiglu_ffn.calls.update(dict.fromkeys(FFN_MODES, 0))`.  The
    count stays with this function when a caller wraps the module's
    name."""
    mode = "dense" if not cfg.enabled or state is None else cfg.mode
    if mode not in FFN_MODES:
        raise ValueError(f"unknown DSG mode {cfg.mode!r}")
    _calls[mode] += 1
    if mode != "gather_shared" and pctx.model_sharded(p.w_up, 1):
        # weights split over 'model' (the spec rule's column / row
        # parallel layout): the tensor-parallel body
        return _tp_ffn(p, x, state if mode == "mask" else None, cfg,
                       "swiglu")
    if mode == "dense":
        return swiglu_dense(p, x)
    if mode == "gather_shared":
        ctx = pctx.current()
        if (ctx is not None and ctx.n_model > 1
                and p.w_gate.shape[1] % (ctx.n_model * cfg.block) == 0):
            return swiglu_dsg_gather_sharded(p, x, state, cfg)
        return swiglu_dsg_gather(p, x, state, cfg)
    return swiglu_dsg_mask(p, x, state, cfg)


swiglu_ffn.calls = _calls


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's jax.nn.gelu: the tanh approximation (its
    default), not torch's exact erf form."""
    return F.gelu(x, approximate="tanh")


def gelu_dense(p: GeluFFN, x: torch.Tensor) -> torch.Tensor:
    return gelu(x @ p.w_up) @ p.w_down


_gelu_calls = dict.fromkeys(FFN_MODES, 0)


def gelu_ffn(p: GeluFFN, x: torch.Tensor, state: Optional[dict],
             cfg: DSGConfig) -> torch.Tensor:
    """GELU FFN (whisper) with DSG on the up projection: "mask" zeroes the
    dropped groups after the GELU, "gather_shared" multiplies only the
    batch-shared kept groups' blocks.  `gelu_ffn.calls` counts the calls
    of each mode, as `swiglu_ffn.calls` does."""
    mode = "dense" if not cfg.enabled or state is None else cfg.mode
    if mode not in FFN_MODES:
        raise ValueError(f"unknown DSG mode {cfg.mode!r}")
    _gelu_calls[mode] += 1
    if mode != "gather_shared" and pctx.model_sharded(p.w_up, 1):
        return _tp_ffn(p, x, state if mode == "mask" else None, cfg,
                       "gelu")
    if mode == "dense":
        return gelu_dense(p, x)
    if mode == "gather_shared":
        idx = shared_topk_indices(x, state, cfg, p.w_up.shape[1])
        wu, wd = _gather_blocks(p, idx, cfg.block)
        h = gelu(torch.einsum("...d,kdb->...kb", x, wu))
        return torch.einsum("...kb,kbd->...d", h, wd)
    mask = drs_group_mask(x, state, cfg)
    h = masks.apply_expanded(gelu(x @ p.w_up), mask, cfg.block)
    return h @ p.w_down


gelu_ffn.calls = _gelu_calls


def swiglu_csr_masked(p: SwiGLU, x: torch.Tensor, idx: torch.Tensor,
                      counts: torch.Tensor, *, block: int) -> torch.Tensor:
    """Masked-dense reference for a per-lane CSR selection: expand the
    index list to a dense group mask and run the full products.
    x (B, S, d), idx (B, K), counts (B,)."""
    mask = sparse_mask.csr_to_dense(idx, counts, p.w_gate.shape[1] // block)
    h = masks.apply_expanded(_gate_up(p, x), masks.freeze(mask[:, None, :]),
                             block)
    return h @ p.w_down


def swiglu_csr(p: SwiGLU, x: torch.Tensor, idx: torch.Tensor,
               counts: torch.Tensor, *, block: int,
               apply: str = "auto") -> torch.Tensor:
    """Group-CSR SwiGLU decode step.  Both modes run `ops.dsg_ffn_csr`,
    where the device decides: "auto" takes the kernel for CUDA tensors and
    its plain version for CPU tensors; "kernel" raises for a tensor that
    is not on CUDA."""
    if apply not in ("auto", "kernel"):
        raise ValueError(f"unknown CSR FFN apply mode {apply!r} (the port "
                         f"has 'auto' and 'kernel')")
    if x.shape[1] != 1:
        raise ValueError(
            f"CSR FFN kernel is a decode step (one token per lane), got "
            f"S={x.shape[1]}; use swiglu_csr_masked for multi-token rows")
    if apply == "kernel" and x.device.type != "cuda":
        raise RuntimeError(f"apply='kernel' needs CUDA tensors, got a "
                           f"{x.device.type} tensor")
    from repro_torch.kernels import ops
    y = ops.dsg_ffn_csr(x[:, 0], p.w_gate, p.w_up, p.w_down, idx, counts,
                        block=block)
    return y[:, None, :]
