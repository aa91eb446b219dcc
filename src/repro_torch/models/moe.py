"""Mixture-of-Experts FFN (the port of `repro.models.moe`), local experts
only.

Dispatch is capacity-based gather/scatter: each (token, k) pair takes a
slot (expert, position) from a cumulative count in token-major (T·K)
order, tokens are gathered into (E, C, d) buffers, run through the expert
products, and combined back weighted by their renormalised router
probability.  Pairs past an expert's capacity are dropped: they write a
sentinel row that is cut off, and add nothing to their token.

DSG composes inside each expert: per-expert f(W) buffers (E, k, F_e)
estimate the expert's gate pre-activations and mask neuron groups of the
(E, C, G) scores exactly as the reference's flattened layout does, so in
"shared" threshold mode row 0 (expert 0's first slot, a zero row when
expert 0 received no token) sets every slot's threshold.

Everything stays on the device with fixed shapes (no boolean indexing, no
`nonzero`, no read-back), so the fused decode chunk captures the routed
body in a CUDA graph.  The combine gathers each token's contributions and
adds them in ascending expert order from 0.0 in f32, the order in which
the reference's scatter-add visits one token, with no atomics.

Expert parallelism: given a mesh whose 'model' axis (> 1) divides the
experts, the routed body runs inside a shard_map over that mesh, as the
reference's does: each 'model' shard takes its E / model local experts
(starting at rank · E_local) over its rows of the batch, with capacity
counted from those rows (t_local = T over the batch axes' product), and
the shards' outputs are summed over 'model' (a token's experts can live
on different shards).
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import drs, masks
from repro_torch.core.dsg_linear import (DSGConfig, SwiGLU, init_swiglu,
                                         swiglu_ffn)
from repro_torch.models.layers import dense_init


class MoE(nn.Module):
    """Router (d, E), always f32; expert weights w_gate/w_up (E, d, F_e),
    w_down (E, F_e, d); `shared` a SwiGLU of width n_shared · F_e, or
    None."""

    def __init__(self, router: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor,
                 shared: Optional[SwiGLU] = None):
        super().__init__()
        self.router = nn.Parameter(router, requires_grad=False)
        self.w_gate = nn.Parameter(w_gate, requires_grad=False)
        self.w_up = nn.Parameter(w_up, requires_grad=False)
        self.w_down = nn.Parameter(w_down, requires_grad=False)
        self.shared = shared


def init_moe(d: int, n_experts: int, d_ff_e: int, n_shared: int, *,
             generator: torch.Generator, dtype: torch.dtype,
             device=None) -> MoE:
    """Random weights with the reference's scales; the router in f32."""
    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)
    router = dense_init((d, n_experts), d, generator=generator,
                        dtype=torch.float32, device=device)
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff_e)
    shared = None
    if n_shared > 0:
        shared = init_swiglu(d, n_shared * d_ff_e, generator=generator,
                             dtype=dtype, device=device)
    return MoE(router, normal((n_experts, d, d_ff_e), sc_in),
               normal((n_experts, d, d_ff_e), sc_in),
               normal((n_experts, d_ff_e, d), sc_out), shared)


def router_topk(probs: torch.Tensor, k: int):
    """`lax.top_k` over the last dim: the k largest, descending, ties
    broken toward the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert: max(1, int(capacity_factor · T · top_k / E))."""
    return max(1, int(capacity_factor * n_tokens * top_k / n_experts))


def dispatch(top_e: torch.Tensor, e_local: int, cap: int, e_start: int = 0):
    """Slot assignment of the (T, K) expert choices in token-major order
    onto the local experts e_start .. e_start + e_local - 1: (slot_e,
    slot_p, in_cap), each (T·K,), slot_e counted from e_start.  A pair's
    position is the count of earlier pairs that chose its expert; pairs
    at position >= cap, or whose expert is not local, are dropped to the
    sentinel expert `e_local`, position 0."""
    local_e = top_e.reshape(-1) - e_start
    is_local = (local_e >= 0) & (local_e < e_local)
    local_e = torch.where(is_local, local_e, e_local)
    onehot = (local_e[:, None] == torch.arange(
        e_local, device=top_e.device)).to(torch.int64)           # (T*K, E_l)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    in_cap = is_local & (pos < cap)
    slot_e = torch.where(in_cap, local_e, e_local)
    slot_p = torch.where(in_cap, pos, 0)
    return slot_e, slot_p, in_cap


def routed_body(x2d: torch.Tensor, logits: torch.Tensor, p,
                e_local: int, n_k: int, cap: int,
                dsg_fw: Optional[torch.Tensor],
                dsg_r: Optional[torch.Tensor],
                dsg: DSGConfig, e_start: int = 0) -> torch.Tensor:
    """The routed experts over x2d (T, d), each token through its n_k
    experts at `cap` slots an expert: (T, d) in x2d's dtype.  `p` holds
    (as w_gate, w_up, w_down) the e_local experts from global index
    e_start on: all E of them from 0 without expert parallelism; a
    token's pairs with other experts add nothing here."""
    w_gate, w_up, w_down = p.w_gate, p.w_up, p.w_down
    t, d = x2d.shape
    probs = torch.softmax(logits.float(), dim=-1)                  # (T, E)
    top_w, top_e = router_topk(probs, n_k)                         # (T, K)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    slot_e, slot_p, in_cap = dispatch(top_e, e_local, cap, e_start)
    flat_tok = torch.arange(t * n_k, device=x2d.device) // n_k
    # (E + 1, C) token index per slot: empty slots (and the sentinel row
    # the dropped pairs write) hold t, the appended zero row
    idx_buf = torch.full((e_local + 1, cap), t, dtype=torch.int64,
                         device=x2d.device)
    idx_buf = idx_buf.index_put((slot_e, slot_p), flat_tok)[:e_local]

    x_pad = torch.cat([x2d, x2d.new_zeros(1, d)], dim=0)
    xg = x_pad[idx_buf]                                            # (E, C, d)
    h = F.silu(torch.bmm(xg, w_gate)) * torch.bmm(xg, w_up)
    if dsg.enabled and dsg_fw is not None:
        # per-expert DRS: f(X) @ f(W_e) -> group mask over the expert's F,
        # selected over the flattened (E, C, G) scores as the reference's
        fx = xg @ dsg_r.t()                                        # (E, C, k)
        scores = drs.group_scores(torch.bmm(fx, dsg_fw), dsg.drs_cfg())
        mask = drs.select_mask(scores, h.shape[-1], dsg.drs_cfg())
        h = masks.apply_expanded(h, masks.freeze(mask), dsg.block)
    y = torch.bmm(h, w_down)                                       # (E, C, d)

    # combine: each token's in-capacity contributions, in ascending
    # expert order, summed from 0.0 in f32 (a dropped pair adds +0.0)
    order = torch.argsort(top_e, dim=-1, stable=True)              # (T, K)
    # dropped and other shards' pairs read a clamped slot and add +0.0
    se = slot_e.view(t, n_k).gather(1, order).clamp(max=e_local - 1)
    sp = slot_p.view(t, n_k).gather(1, order)
    ok = in_cap.view(t, n_k).gather(1, order)
    w = top_w.gather(1, order)
    contrib = y[se, sp].float() * w[..., None]                     # (T, K, d)
    contrib = torch.where(ok[..., None], contrib, 0.0)
    out = torch.zeros((t, d), dtype=torch.float32, device=x2d.device)
    for k in range(n_k):
        out = out + contrib[:, k]
    return out.to(x2d.dtype)


def aux_load_balance_loss(logits: torch.Tensor, top_e: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.reshape(-1, n_experts).mean(dim=0)
    first = top_e[..., 0].reshape(-1)
    ce = (first[:, None] == torch.arange(n_experts, device=first.device)
          ).float().mean(dim=0)
    return n_experts * (me * ce).sum()


def aux_probs_loss(logits: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Sort-free load-balance surrogate: n_E · sum(mean_prob²)."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.reshape(-1, n_experts).mean(dim=0)
    return n_experts * (me * me).sum()


def _use_ep(mesh, n_experts: int) -> bool:
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return False
    from repro_torch.parallel.collectives import axis_size
    n = axis_size("model", mesh)
    return n > 1 and n_experts % n == 0


def _routed_ep(x2d, logits, p, mesh, batch_axes, n_experts: int,
               top_k: int, capacity_factor: float, dsg_fw, dsg_r,
               dsg: DSGConfig):
    """The routed body under expert parallelism: a shard_map over `mesh`
    with the rows split over `batch_axes` and the experts over 'model',
    the local outputs summed over 'model'.  Without DSG a zero (E, 1, 1)
    tensor stands in for f(W), as in the reference."""
    from repro_torch.parallel.collectives import axis_index, axis_size, \
        psum, shard_map
    from repro_torch.parallel.sharding import P

    e_local = n_experts // axis_size("model", mesh)
    div = 1
    for a in batch_axes or ():
        div *= axis_size(a, mesh)
    cap = capacity(x2d.shape[0] // max(1, div), n_experts, top_k,
                   capacity_factor)

    def body(x_l, lg_l, wg, wu, wd, fw, r):
        e_start = axis_index("model", mesh) * e_local
        local = SimpleNamespace(w_gate=wg, w_up=wu, w_down=wd)
        out = routed_body(x_l, lg_l, local, e_local, top_k, cap,
                          fw if dsg_fw is not None else None, r, dsg,
                          e_start)
        return psum(out, "model", mesh)

    bspec, espec = P(batch_axes, None), P("model", None, None)
    fw_in = dsg_fw if dsg_fw is not None else \
        torch.zeros((n_experts, 1, 1), dtype=x2d.dtype, device=x2d.device)
    return shard_map(
        body, mesh, (bspec, bspec, espec, espec, espec, espec,
                     None if dsg_r is None else P()),
        bspec)(x2d, logits, p.w_gate, p.w_up, p.w_down, fw_in, dsg_r)


def moe_ffn(p: MoE, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float, dsg: DSGConfig,
            dsg_state: Optional[dict] = None, mesh=None, batch_axes=None,
            aux_kind: Optional[str] = "topk"):
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar).  The capacity counts
    every token of the call (T = B · S), or with expert parallelism over
    `mesh` the rows of a batch shard (T over the product of the
    `batch_axes`' sizes).  `aux_kind` None skips the auxiliary loss (aux
    is then None): serving has no use for it."""
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    logits = x2d.float() @ p.router
    aux = None
    if aux_kind == "probs":
        aux = aux_probs_loss(logits, n_experts)
    elif aux_kind is not None:
        _, top_e = router_topk(torch.softmax(logits, -1), top_k)
        aux = aux_load_balance_loss(logits, top_e, n_experts)
    on = dsg.enabled and bool(dsg_state)
    dsg_fw = dsg_state["fw_experts"] if on else None
    dsg_r = dsg_state["r"] if on else None
    if _use_ep(mesh, n_experts):
        y2d = _routed_ep(x2d, logits, p, mesh, batch_axes, n_experts,
                         top_k, capacity_factor, dsg_fw, dsg_r, dsg)
    else:
        y2d = routed_body(x2d, logits, p, n_experts, top_k,
                          capacity(x2d.shape[0], n_experts, top_k,
                                   capacity_factor), dsg_fw, dsg_r, dsg)
    y = y2d.reshape(b, s, d)
    if p.shared is not None:
        sh_state = dsg_state.get("shared") if dsg_state else None
        y = y + swiglu_ffn(p.shared, x, sh_state, dsg)
    return y, aux
