"""Attention: GQA + RoPE for prompt prefill and paged per-lane decode,
with a chunked online-softmax path for long prompts.

Weights keep the reference layout: wq (d, H, D), wk/wv (d, Kv, D),
wo (H, D, d).  Two cache kinds reach `self_attention`:

  * a dense cache {'k', 'v'} of (B, Smax, Kv, D), written in place: at
    the int `cache_pos` onwards during prefill (and zamba's ring decode,
    whose slots' positions `cache_kv_pos` gives), at each lane's own
    position of the (B,) `cache_pos` during decode;
  * the paged pools {'k', 'v'} of (P, ps, Kv, D) plus a page table during
    decode, updated in place by the paged executor.

The encoder-decoder family adds `cross_attention` over encoder-memory K/V
(`memory_kv`, computed once at prefill): no RoPE, f32 scores.

Inside a parallel context on a mesh with a 'model' axis, a layer whose
weights are DTensors runs as shard_map bodies that keep the reference's
layout (its sharding constraints, as GSPMD partitions them): "head" mode
projects each rank's own q heads and the K/V heads they read, attends
them and sums the out-projection's partial outputs over 'model'; "seq"
mode (replicated weights) attends each rank's own query rows over all
keys and gathers the rows; decode over a cache sequence-sharded over
'model' is split-KV (every head's q gathered, each rank's key rows
scored, the softmax's max and sum and the product with V reduced over
'model').  A dense cache laid out as a DTensor sequence-sharded over
'model' is written in place, each rank writing the rows that fall in
its shard.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.models.layers import apply_rope, dense_init
from repro_torch.parallel import context as pctx
from repro_torch.parallel.sharding import is_dtensor

NEG = -1e30


class Attention(nn.Module):
    def __init__(self, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                 wo: torch.Tensor):
        super().__init__()
        self.wq = nn.Parameter(wq, requires_grad=False)   # (d, H, D)
        self.wk = nn.Parameter(wk, requires_grad=False)   # (d, Kv, D)
        self.wv = nn.Parameter(wv, requires_grad=False)   # (d, Kv, D)
        self.wo = nn.Parameter(wo, requires_grad=False)   # (H, D, d)


def init_attention(d: int, n_heads: int, n_kv: int, head_dim: int, *,
                   generator: torch.Generator, dtype: torch.dtype,
                   device=None) -> Attention:
    kw = dict(generator=generator, dtype=dtype, device=device)
    return Attention(dense_init((d, n_heads, head_dim), d, **kw),
                     dense_init((d, n_kv, head_dim), d, **kw),
                     dense_init((d, n_kv, head_dim), d, **kw),
                     dense_init((n_heads, head_dim, d), n_heads * head_dim,
                                **kw))


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(x.shape[:-1] + (h, k))


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matmul."""
    h, k, d = wo.shape
    o = pctx.whole_groups(o, 1, dim=-2)     # heads split unevenly: whole
    return o.reshape(o.shape[:-2] + (h * k,)) @ wo.reshape(h * k, d)


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    """Validity from absolute positions: q_pos (S,) -> (S, T), per-lane
    q_pos (B, S) -> (B, S, T)."""
    qp = q_pos[..., :, None]
    kp = kv_pos[None, :]
    m = (kp >= 0).expand(torch.broadcast_shapes(qp.shape, kp.shape))
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (kp > qp - window)
    return m


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, Kv, D) -> (B, T, H, D), each kv head repeated H/Kv times."""
    n_kv = k.shape[2]
    return k if n_kv == n_heads else k.repeat_interleave(n_heads // n_kv, 2)


def attend_direct(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                  window: int, bf16_scores: bool = False) -> torch.Tensor:
    """Direct softmax attention; q (B, S, H, D), k/v (B, T, H, D).
    bf16_scores keeps the score and probability tensors in bf16 with the
    softmax max/sum statistics in f32 (bf16 inputs only)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    m = _mask(q_pos, kv_pos, causal, window)
    m = m[:, None] if m.ndim == 3 else m[None, None]
    if bf16_scores and q.dtype == torch.bfloat16:
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        s = torch.where(m, s, NEG)
        mx = s.float().amax(dim=-1, keepdim=True)
        p = torch.exp(s.float() - mx)
        p = (p / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16)
        return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(m, s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                   window: int, q_chunk: int = 1024,
                   kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over (q_chunk, kv_chunk) tiles, in f32,
    each query chunk's running max, sum and output carried across the key
    chunks in order (the reference's double lax.scan, in plain PyTorch as
    the reference's is plain XLA).  Keeps the live score tile at (B, H,
    q_chunk, kv_chunk), for prompts whose (S, T) scores cannot exist.
    q (B, S, H, D), k/v (B, T, H, D); positions (S,) and (T,)."""
    b, s_len, h, d = q.shape
    t_len = k.shape[1]
    q_chunk = min(q_chunk, s_len)
    kv_chunk = min(kv_chunk, t_len)
    nq, nk = s_len // q_chunk, t_len // kv_chunk
    if nq * q_chunk != s_len or nk * kv_chunk != t_len:
        raise ValueError(f"chunking must tile exactly: {s_len}/{q_chunk}, "
                         f"{t_len}/{kv_chunk}")
    scale = 1.0 / math.sqrt(d)
    outs = []
    for i in range(nq):
        q_i = q[:, i * q_chunk:(i + 1) * q_chunk].float()
        qpos_i = q_pos[i * q_chunk:(i + 1) * q_chunk]
        m_run = torch.full((b, h, q_chunk), NEG, device=q.device)
        l_run = torch.zeros((b, h, q_chunk), device=q.device)
        acc = torch.zeros((b, h, q_chunk, d), device=q.device)
        for j in range(nk):
            sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
            sc = torch.einsum("bqhd,bkhd->bhqk", q_i, k[:, sl].float()) * scale
            msk = _mask(qpos_i, kv_pos[sl], causal, window)[None, None]
            sc = torch.where(msk, sc, NEG)
            m_new = torch.maximum(m_run, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None]) * msk
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, v[:, sl].float())
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-20)[..., None]
        outs.append(out.transpose(1, 2))                  # (b, q_chunk, h, d)
    return torch.cat(outs, dim=1).to(q.dtype)


CHUNK_THRESHOLD = 1 << 24   # S*T above which the chunked path is used


def _check_paged_kernel(mode: str, device: torch.device) -> None:
    """Both modes run `ops.paged_decode_attention`, where the device decides:
    "auto" takes the kernel for CUDA tensors and its plain version for CPU
    tensors; "kernel" raises for a tensor that is not on CUDA."""
    if mode not in ("auto", "kernel"):
        raise ValueError(f"unknown paged_attn_kernel mode {mode!r} (the "
                         f"port has 'auto' and 'kernel')")
    if mode == "kernel" and device.type != "cuda":
        raise RuntimeError(f"paged_attn_kernel='kernel' needs CUDA tensors, "
                           f"got a {device.type} tensor")


def self_attention(p: Attention, x: torch.Tensor, *, n_heads: int,
                   n_kv: int, rope_theta: float, q_pos: torch.Tensor,
                   causal: bool = True, window: int = 0,
                   cache: Optional[dict] = None, cache_pos=None,
                   cache_kv_pos: Optional[torch.Tensor] = None,
                   page_table: Optional[torch.Tensor] = None,
                   live_pages: Optional[int] = None,
                   paged_kernel: str = "auto", shard: str = "auto",
                   bf16_scores: bool = False, kv_out: bool = False):
    """Self-attention over x (B, S, d) -> (out, cache).

    cache=None: attend over the S new tokens; returns their K/V.
    Dense cache: with an int cache_pos (prefill) the new K/V go to
    positions cache_pos onwards and the tokens attend over the cache up to
    their end; with per-lane (B,) depths (decode, S == 1) each lane writes
    at its depth and attends over the whole cache, causally masked.  With
    `cache_kv_pos` (T,), the absolute position each slot holds (zamba's
    ring), the new K/V go to the scalar cache_pos onwards, clamped into
    the cache as the reference's dynamic_update_slice clamps it, and the
    tokens attend over every slot at those positions.
    Paged decode (page_table given): cache holds one layer's page pools,
    cache_pos the per-lane (B,) int32 depths, S == 1.
    `ops.paged_decode_attention` (the CUDA kernel, or its plain bounded
    gather for CPU tensors) writes the new row into the pools in place and
    attends over each lane's positions <= its depth within the leading
    `live_pages` pages.
    `shard` picks the sharded layout inside a parallel context ("auto":
    "head" when the heads divide the model axis, else "seq"); there, with
    no cache, the new K/V come back only with `kv_out` (laid out by the
    K/V heads' spec rule), else as None.
    """
    s = x.shape[1]
    mode = pctx.resolve_attn_shard(shard, n_heads)
    if mode != "none" and page_table is None and is_dtensor(p.wq):
        return _tp_self_attention(
            p, x, n_heads=n_heads, rope_theta=rope_theta, q_pos=q_pos,
            causal=causal, window=window, cache=cache, cache_pos=cache_pos,
            cache_kv_pos=cache_kv_pos, bf16_scores=bf16_scores, mode=mode,
            kv_out=kv_out)
    q = _proj(x, p.wq)
    k_new = _proj(x, p.wk)
    v_new = _proj(x, p.wv)
    rope_pos = q_pos if q_pos.ndim == 2 else q_pos[None, :]
    if rope_theta > 0:
        q = apply_rope(q, rope_pos, rope_theta)
        k_new = apply_rope(k_new, rope_pos, rope_theta)

    if cache is None:
        k, v, kv_pos = k_new, v_new, q_pos
    elif page_table is not None:
        if s != 1 or not torch.is_tensor(cache_pos) or cache_pos.ndim != 1:
            raise NotImplementedError(
                "paged KV cache supports per-lane single-token decode only")
        _check_paged_kernel(paged_kernel, x.device)
        from repro_torch.kernels import ops
        o, _, _ = ops.paged_decode_attention(
            q[:, 0].contiguous(), k_new[:, 0].contiguous(),
            v_new[:, 0].contiguous(), cache["k"], cache["v"], page_table,
            cache_pos, window=window, num_pages=live_pages or 0)
        return _out(o[:, None], p.wo), cache
    elif cache_kv_pos is not None:
        t = cache["k"].shape[1]
        if is_dtensor(cache["k"]):
            # a sharded cache (the encoder-decoder's under a mesh): the
            # batch's one int position, written shard by shard
            start = min(max(int(cache_pos), 0), t - s)
            _write_rows(cache["k"], k_new, start)
            _write_rows(cache["v"], v_new, start)
        else:
            rows = (torch.as_tensor(cache_pos, device=x.device).long()
                    .clamp(0, t - s) + torch.arange(s, device=x.device))
            cache["k"][:, rows] = _like(cache["k"], k_new)
            cache["v"][:, rows] = _like(cache["v"], v_new)
        k, v, kv_pos = cache["k"], cache["v"], cache_kv_pos
    elif torch.is_tensor(cache_pos):
        # per-lane dense decode: lane i writes its token at its own
        # position, then attends over the whole stripe under the causal
        # mask (an index write and no read-back, so it can be captured).
        # The write index is clamped into the stripe, as the reference's
        # dynamic_update_slice clamps it: a fused chunk whose lanes are all
        # done feeds them the donor's position, which can be max_seq
        if s != 1 or cache_pos.ndim != 1:
            raise NotImplementedError(
                "the dense cache takes per-lane single-token decode or a "
                "scalar write position")
        pos = cache_pos.long().clamp(0, cache["k"].shape[1] - 1)
        _write_lanes(cache["k"], k_new[:, 0], pos)
        _write_lanes(cache["v"], v_new[:, 0], pos)
        k, v = cache["k"], cache["v"]
        kv_pos = torch.arange(k.shape[1], device=x.device)
    else:
        end = cache_pos + s
        _write_rows(cache["k"], k_new, cache_pos)
        _write_rows(cache["v"], v_new, cache_pos)
        k, v = cache["k"][:, :end], cache["v"][:, :end]
        kv_pos = torch.arange(end, device=x.device)

    # the reference attends a prefill over the whole cache (Smax keys, the
    # ones past the prompt masked), and switches to the chunked path when
    # S * Smax exceeds CHUNK_THRESHOLD: the same switch, on the same keys
    # (per-lane decode, q_pos 2-D, is one token and never needs it)
    t_ref = k.shape[1] if cache is None else cache["k"].shape[1]
    chunked = s * t_ref > CHUNK_THRESHOLD and q_pos.ndim == 1
    if chunked and cache is not None:
        k, v = cache["k"], cache["v"]
        kv_pos = torch.arange(k.shape[1], device=x.device)
    kf, vf = repeat_kv(k, n_heads), repeat_kv(v, n_heads)

    if chunked:
        o = attend_chunked(q, kf, vf, q_pos, kv_pos, causal, window)
    else:
        o = attend_direct(q, kf, vf, q_pos, kv_pos, causal, window,
                          bf16_scores=bf16_scores)
    out = _out(o, p.wo)
    if cache is None:
        return out, {"k": k_new, "v": v_new}
    return out, cache


def _tp_specs(mode: str, n_kv: int):
    """(batch axes, the q/wq/wo head entry, the k/v/wk/wv head entry) of
    the sharded layout: heads over 'model' in head mode, K/V heads too
    when they divide the axis (the weights' spec rule, `models.specs`);
    every head on every rank in seq mode."""
    ctx = pctx.current()
    head = "model" if mode == "head" else None
    kv = head if n_kv % ctx.n_model == 0 else None
    return ctx.ax.batch, head, kv


def _positions(q_pos: torch.Tensor):
    """Per-lane positions (B, S) go into a body by the batch's spec;
    batch-shared ones (S,) as they are."""
    from repro_torch.parallel.sharding import P
    if q_pos.ndim == 2:
        return pctx.replicated(q_pos), P(pctx.batch_axes(), None)
    return q_pos, None


def _tp_project(x, ws: tuple, head, q_pos=None, rope_theta: float = 0.0
                ) -> tuple:
    """x (B, S, d) -> one (B, S, h, D) projection per weight of `ws`, as
    a shard_map body: each rank multiplies its input (replicated over
    'model') by its own heads of the weights (`head` 'model'), or by
    whole replicated weights (`head` None), with no collective.  With
    rope_theta > 0 the first output (q, or k) is rotated at `q_pos`."""
    from repro_torch.parallel.collectives import shard_map
    from repro_torch.parallel.sharding import P
    ctx = pctx.current()
    ba = ctx.ax.batch
    pos, pos_spec = (_positions(q_pos) if rope_theta > 0 else (None, None))

    def body(x_l, pos_l, *w_l):
        out = [_proj(x_l, w) for w in w_l]
        if rope_theta > 0:
            rp = pos_l if pos_l.ndim == 2 else pos_l[None, :]
            out[0] = apply_rope(out[0], rp, rope_theta)
        return tuple(out)

    return shard_map(
        body, ctx.mesh,
        (P(ba, None, None), pos_spec) + (P(None, head, None),) * len(ws),
        (P(ba, None, head, None),) * len(ws),
        redundant=() if head else ("model",))(
            pctx.replicated(x), pos, *ws)


def _kv_heads(k: torch.Tensor, group: int, h0, h_l: int, kv0=0
              ) -> torch.Tensor:
    """Query heads h0 .. h0 + h_l of `k` (B, T, n, D), which holds the K/V
    heads from kv0 on, each K/V head serving `group` query heads
    (`repeat_kv` for those heads alone)."""
    if group == 1 and h_l == k.shape[2]:
        return k
    idx = torch.div(h0 + torch.arange(h_l, device=k.device), group,
                    rounding_mode="floor") - kv0
    return k.index_select(2, idx)


def _tp_core(q, k, v, wo, qp, kv_pos, *, mesh, group: int, h0, kv0,
             head, rows, causal: bool, window: int, bf16_scores: bool,
             chunked: bool):
    """Inside a body: this rank's query heads h0.. (k/v holding the K/V
    heads from kv0 on) or rows attended, times its rows of wo, summed
    over 'model' in head mode or, in seq mode with `rows`, the rows
    gathered."""
    from repro_torch.parallel.collectives import all_gather, psum
    h_l = q.shape[2]
    k = _kv_heads(k, group, h0, h_l, kv0)
    v = _kv_heads(v, group, h0, h_l, kv0)
    if chunked:
        o = attend_chunked(q, k, v, qp, kv_pos, causal, window)
    else:
        o = attend_direct(q, k, v, qp, kv_pos, causal, window,
                          bf16_scores=bf16_scores)
    out = _out(o, wo)
    if head:
        return psum(out, "model", mesh)
    if rows:
        return all_gather(out, "model", 1, mesh)
    return out


def _tp_attention(p: Attention, x, q_pos, *, n_heads: int,
                  rope_theta: float, causal: bool, window: int,
                  bf16_scores: bool, chunked: bool, mode: str,
                  kv_out: bool = False):
    """Attention with no cache (training, the encoder) as one shard_map
    body: the projections of this rank's query heads and of the K/V
    heads they read (head mode: K/V heads that do not divide the axis
    are sliced from the replicated weights), or of its query rows and
    every key (seq mode, replicated weights), then `_tp_core`.  Where
    seq mode's rows do not divide the axis, every rank computes them
    all.  Returns the output (B, S, d), replicated over 'model'."""
    from repro_torch.parallel.collectives import axis_index, shard_map
    from repro_torch.parallel.sharding import P
    ctx = pctx.current()
    mesh, n = ctx.mesh, ctx.n_model
    n_kv = p.wk.shape[1]
    ba, head, kv = _tp_specs(mode, n_kv)
    group = n_heads // n_kv
    s = x.shape[1]
    rows = "model" if mode == "seq" and s % n == 0 else None
    pos, pos_spec = _positions(q_pos)
    if kv_out and head and not kv:
        raise NotImplementedError(
            f"the K/V of {n_kv} heads split over a model axis of {n}")

    def body(x_l, wq, wk, wv, wo, qp):
        h_l = wq.shape[1]
        me = axis_index("model", mesh)
        h0 = me * h_l if head else 0
        kv0 = me * wk.shape[1] if kv else 0
        if head and not kv:     # the replicated K/V heads this rank reads
            kv0 = h0 // group
            hi = (h0 + h_l - 1) // group + 1
            wk, wv = wk[:, kv0:hi], wv[:, kv0:hi]
        xq, qq = x_l, qp
        if rows:
            start = me * (s // n)
            xq = x_l[:, start:start + s // n]
            qq = qp[..., start:start + s // n]
        q, k, v = _proj(xq, wq), _proj(x_l, wk), _proj(x_l, wv)
        if rope_theta > 0:
            q = apply_rope(q, qq if qq.ndim == 2 else qq[None, :],
                           rope_theta)
            k = apply_rope(k, qp if qp.ndim == 2 else qp[None, :],
                           rope_theta)
        out = _tp_core(q, k, v, wo, qq, qp, mesh=mesh, group=group, h0=h0,
                       kv0=kv0, head=head, rows=rows, causal=causal,
                       window=window, bf16_scores=bf16_scores,
                       chunked=chunked)
        return (out, k, v) if kv_out else out

    kv_spec = P(ba, None, kv, None)
    return shard_map(
        body, mesh,
        (P(ba, None, None), P(None, head, None), P(None, kv, None),
         P(None, kv, None), P(head, None, None), pos_spec),
        (P(ba, None, None), kv_spec, kv_spec) if kv_out else
        P(ba, None, None),
        redundant=("model",) if mode == "seq" and not rows else ())(
            pctx.replicated(x), p.wq, p.wk, p.wv, p.wo, pos)


def _tp_attend(q, k, v, wo, q_pos, kv_pos, *, n_heads: int, causal: bool,
               window: int, bf16_scores: bool, chunked: bool, mode: str):
    """`_tp_core` as a body of its own, on projections already made:
    q (B, S, H, D) by its heads in head mode, k/v (B, T, Kv, D) by their
    heads where they divide the axis, else whole; in seq mode q's rows
    are cut here.  kv_pos (T,) global.  Returns the output (B, S, d),
    replicated over 'model'."""
    from repro_torch.parallel.collectives import axis_index, shard_map
    from repro_torch.parallel.sharding import P
    ctx = pctx.current()
    mesh, n = ctx.mesh, ctx.n_model
    n_kv = k.shape[2]
    ba, head, kv = _tp_specs(mode, n_kv)
    s = q.shape[1]
    rows = "model" if mode == "seq" and s % n == 0 else None
    pos, pos_spec = _positions(q_pos)

    def body(q_l, k_l, v_l, wo_l, qp):
        me = axis_index("model", mesh)
        if rows:
            qp = qp[..., me * (s // n):(me + 1) * (s // n)]
        return _tp_core(q_l, k_l, v_l, wo_l, qp, kv_pos, mesh=mesh,
                        group=n_heads // n_kv,
                        h0=me * q_l.shape[2] if head else 0,
                        kv0=me * k_l.shape[2] if kv else 0, head=head,
                        rows=rows, causal=causal, window=window,
                        bf16_scores=bf16_scores, chunked=chunked)

    return shard_map(
        body, mesh,
        (P(ba, rows, head, None), P(ba, None, kv, None),
         P(ba, None, kv, None), P(head, None, None), pos_spec),
        P(ba, None, None),
        redundant=("model",) if mode == "seq" and not rows else ())(
            q, k, v, wo, pos)


def _tp_split_kv(q, k, v, wo, q_pos, kv_pos, *, n_heads: int, causal: bool,
                 window: int, bf16_scores: bool, mode: str):
    """Split-KV decode as one shard_map body: q (B, 1, H, D) with every
    head on every rank (gathered over 'model' from its projection), the
    keys k/v (B, T, Kv, D) sequence-sharded over 'model' as the cache
    lies.  Each rank scores its own key rows; the softmax's max and sum
    and the probabilities times V are reduced over 'model' (three
    all-reduces, as the reference's partitioner does), then the output
    projection of this rank's heads, summed over 'model' (head mode), or
    of all of them (seq mode).  kv_pos (T,) global.  No backward."""
    from repro_torch.parallel.collectives import (axis_index, pmax, psum,
                                                  shard_map)
    from repro_torch.parallel.sharding import P
    ctx = pctx.current()
    mesh = ctx.mesh
    ba, head, _ = _tp_specs(mode, k.shape[2])
    chunk = -(-k.shape[1] // ctx.n_model)       # DTensor's cut of T
    pos, pos_spec = _positions(q_pos)
    scale = 1.0 / math.sqrt(q.shape[-1])
    bf16 = bf16_scores and q.dtype == torch.bfloat16

    def body(q_l, k_l, v_l, wo_l, qp):
        me = axis_index("model", mesh)
        m = _mask(qp, kv_pos[me * chunk:me * chunk + k_l.shape[1]], causal,
                  window)
        m = m[:, None] if m.ndim == 3 else m[None, None]
        kf, vf = repeat_kv(k_l, n_heads), repeat_kv(v_l, n_heads)
        if bf16:
            sc = torch.einsum("bqhd,bkhd->bhqk", q_l, kf) * scale
            sc = torch.where(m, sc, NEG).float()
        else:
            sc = torch.einsum("bqhd,bkhd->bhqk", q_l.float(),
                              kf.float()) * scale
            sc = torch.where(m, sc, NEG)
        top = pmax(sc.amax(dim=-1, keepdim=True), "model", mesh)
        e = torch.exp(sc - top)
        p = e / psum(e.sum(dim=-1, keepdim=True), "model", mesh)
        if bf16:
            p = p.to(torch.bfloat16).float()
        o = psum(torch.einsum("bhqk,bkhd->bqhd", p, vf.float()), "model",
                 mesh).to(q_l.dtype)
        if head:
            h_l = wo_l.shape[0]
            return psum(_out(o[:, :, me * h_l:(me + 1) * h_l], wo_l),
                        "model", mesh)
        return _out(o, wo_l)

    return shard_map(
        body, mesh,
        (P(ba, None, None, None), P(ba, "model", None, None),
         P(ba, "model", None, None), P(head, None, None), pos_spec),
        P(ba, None, None))(q, k, v, wo, pos)


def _tp_self_attention(p: Attention, x, *, n_heads: int, rope_theta: float,
                       q_pos, causal: bool, window: int, cache, cache_pos,
                       cache_kv_pos, bf16_scores: bool, mode: str,
                       kv_out: bool = False):
    """`self_attention` of a model whose weights are DTensors, in a
    parallel context with a 'model' axis: the projections, the core and
    the output projection as explicit shard_map bodies, so the only
    collectives are the reference's: the output's all-reduce over
    'model', and at decode the gathers of q and of the new K/V row and
    the split-KV softmax's reductions.  With no cache it returns (out,
    None): the K/V of a rank's heads are not laid out for a caller.  A
    cache is written as `self_attention` writes it, shard by shard."""
    n_kv = p.wk.shape[1]
    _, head, kv = _tp_specs(mode, n_kv)
    s = x.shape[1]
    kw = dict(n_heads=n_heads, causal=causal, window=window,
              bf16_scores=bf16_scores, mode=mode)
    if cache is None:
        chunked = s * s > CHUNK_THRESHOLD and q_pos.ndim == 1
        out = _tp_attention(p, x, q_pos, rope_theta=rope_theta,
                            chunked=chunked, kv_out=kv_out, **kw)
        if kv_out:
            return out[0], {"k": out[1], "v": out[2]}
        return out, None
    (q,) = _tp_project(x, (p.wq,), head, q_pos, rope_theta)
    k_new, v_new = _tp_project(x, (p.wk, p.wv), kv, q_pos, rope_theta)
    t = cache["k"].shape[1]
    chunked = s * t > CHUNK_THRESHOLD and q_pos.ndim == 1
    if cache_kv_pos is not None:
        start = min(max(int(cache_pos), 0), t - s)
        _write_rows(cache["k"], k_new, start)
        _write_rows(cache["v"], v_new, start)
        k, v, kv_pos = cache["k"], cache["v"], cache_kv_pos
    elif torch.is_tensor(cache_pos):
        if s != 1 or cache_pos.ndim != 1:
            raise NotImplementedError(
                "the dense cache takes per-lane single-token decode or a "
                "scalar write position")
        pos = cache_pos.long().clamp(0, t - 1)
        _write_lanes(cache["k"], k_new[:, 0], pos)
        _write_lanes(cache["v"], v_new[:, 0], pos)
        k, v = cache["k"], cache["v"]
        kv_pos = torch.arange(t, device=x.device)
    else:
        _write_rows(cache["k"], k_new, cache_pos)
        _write_rows(cache["v"], v_new, cache_pos)
        end = t if chunked else cache_pos + s
        if s == 1 and pctx.model_sharded(cache["k"], 1):
            # one token over the sequence-sharded cache: split-KV, the
            # slots past it masked as causality masks them
            end = t
            k, v = cache["k"], cache["v"]
        elif cache_pos == 0 and not chunked:
            # the rows just written, as the cache holds them
            k, v = k_new.to(cache["k"].dtype), v_new.to(cache["v"].dtype)
        else:
            k, v = cache["k"][:, :end], cache["v"][:, :end]
        kv_pos = torch.arange(end, device=x.device)
    if s == 1 and pctx.model_sharded(k, 1):
        out = _tp_split_kv(q, k, v, p.wo, q_pos, kv_pos, **kw)
    else:
        out = _tp_attend(q, pctx.replicated(k), pctx.replicated(v), p.wo,
                         q_pos, kv_pos, chunked=chunked, **kw)
    ba = pctx.batch_axes()
    return out, {"k": pctx.constrain(cache["k"], ba, "model", None, None),
                 "v": pctx.constrain(cache["v"], ba, "model", None, None)}


def _like(buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """`new` in `buf`'s dtype, gathered whole when `buf` is a plain
    tensor and `new` a DTensor (a replicated cache of a sharded model)."""
    if is_dtensor(new) and not is_dtensor(buf):
        new = new.full_tensor()
    return new.to(buf.dtype)


def _write_rows(buf: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """buf[:, start:start + S] = new (B, S, ...), in place.  A DTensor
    `buf` (batch over dim 0, sequence over dim 1 for split-KV decode) has
    each rank write the rows it holds: DTensor's own slice assignment
    into a sharded dim copies into a gathered temporary and leaves the
    shards as they were."""
    if not is_dtensor(buf):
        buf[:, start:start + new.shape[1]] = _like(buf, new)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pl = buf.device_mesh, buf.placements
    shape, off = compute_local_shape_and_global_offset(buf.shape, mesh, pl)
    if not isinstance(new, DTensor):
        # a plain tensor meets a DTensor as the replicated value
        new = DTensor.from_local(new, mesh, [Replicate()] * len(pl),
                                 run_check=False)
    rows_pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in pl]
    new_l = new.redistribute(mesh, rows_pl).to_local()
    lo = max(start, off[1])
    hi = min(start + new.shape[1], off[1] + shape[1])
    if lo < hi:
        buf.to_local()[:, lo - off[1]:hi - off[1]] = \
            new_l[:, lo - start:hi - start].to(buf.dtype)


def _write_lanes(buf: torch.Tensor, rows: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """buf[b, pos[b]] = rows[b] for every lane b, in place.  buf (B, T,
    ...) may be a DTensor sharded over the batch (dim 0) and over the
    sequence (dim 1, split-KV decode): each rank then writes the lanes it
    holds whose position falls in its rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(buf, DTensor):
        lanes = torch.arange(buf.shape[0], device=buf.device)
        buf[lanes, pos] = _like(buf, rows)
        return
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pl = buf.device_mesh, buf.placements
    shape, off = compute_local_shape_and_global_offset(buf.shape, mesh, pl)
    lane_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in pl]

    def local(t):
        if not isinstance(t, DTensor):
            # a plain tensor meets a DTensor as the replicated value
            t = DTensor.from_local(t, mesh, [Replicate()] * len(pl),
                                   run_check=False)
        return t.redistribute(mesh, lane_pl).to_local()

    rows_l, pos_l = local(rows), local(pos)
    buf_l = buf.to_local()
    p = pos_l.long() - off[1]
    inside = (p >= 0) & (p < shape[1])
    p = p.clamp(0, shape[1] - 1)
    lanes = torch.arange(buf_l.shape[0], device=buf_l.device)
    keep = buf_l[lanes, p]
    mask = inside.reshape((-1,) + (1,) * (keep.ndim - 1))
    buf_l[lanes, p] = torch.where(mask, rows_l.to(buf_l.dtype), keep)


def cross_attention(p: Attention, x: torch.Tensor, mem_k: torch.Tensor,
                    mem_v: torch.Tensor, *, n_heads: int,
                    q_pos: torch.Tensor, shard: str = "auto") -> torch.Tensor:
    """Decoder cross-attention of x (B, S, d) over precomputed encoder K/V
    (B, T, Kv, D): no RoPE, every memory row visible, f32 scores (the
    reference passes no bf16_scores), chunked above CHUNK_THRESHOLD.  On
    a mesh with DTensor weights (`shard`, as `self_attention`'s) each
    rank attends its own heads in head mode, or in seq mode its own query
    rows over the whole memory where the rows divide the model axis; one
    token over a memory sequence-sharded over 'model' is split-KV."""
    kv_pos = torch.arange(mem_k.shape[1], device=x.device)
    chunked = x.shape[1] * mem_k.shape[1] > CHUNK_THRESHOLD
    mode = pctx.resolve_attn_shard(shard, n_heads)
    if mode != "none" and is_dtensor(p.wq):
        _, head, _ = _tp_specs(mode, mem_k.shape[2])
        (q,) = _tp_project(x, (p.wq,), head)
        kw = dict(n_heads=n_heads, causal=False, window=0,
                  bf16_scores=False, mode=mode)
        if x.shape[1] == 1 and pctx.model_sharded(mem_k, 1):
            return _tp_split_kv(q, mem_k, mem_v, p.wo, q_pos, kv_pos, **kw)
        return _tp_attend(q, pctx.replicated(mem_k), pctx.replicated(mem_v),
                          p.wo, q_pos, kv_pos, chunked=chunked, **kw)
    q = _proj(x, p.wq)
    kf = repeat_kv(mem_k, n_heads)
    vf = repeat_kv(mem_v, n_heads)
    if chunked:
        o = attend_chunked(q, kf, vf, q_pos, kv_pos, False, 0)
    else:
        o = attend_direct(q, kf, vf, q_pos, kv_pos, False, 0)
    return _out(o, p.wo)


def memory_kv(p: Attention, memory: torch.Tensor,
              shard: str = "auto") -> tuple:
    """Encoder-memory K/V (B, T, Kv, D) for cross-attention; with sharded
    weights in head mode (`shard`, as `cross_attention`'s) each rank
    projects its own K/V heads."""
    mode = pctx.resolve_attn_shard(shard, p.wq.shape[1])
    if mode != "none" and is_dtensor(p.wk):
        _, _, kv = _tp_specs(mode, p.wk.shape[1])
        return _tp_project(memory, (p.wk, p.wv), kv)
    return _proj(memory, p.wk), _proj(memory, p.wv)
