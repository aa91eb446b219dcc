"""Attention: GQA + RoPE for prompt prefill and paged per-lane decode.

Weights keep the reference layout: wq (d, H, D), wk/wv (d, Kv, D),
wo (H, D, d).  Two cache kinds reach `self_attention`:

  * a dense cache {'k', 'v'} of (B, Smax, Kv, D), written in place: at
    the int `cache_pos` onwards during prefill, at each lane's own
    position of the (B,) `cache_pos` during decode;
  * the paged pools {'k', 'v'} of (P, ps, Kv, D) plus a page table during
    decode, updated in place by the paged executor.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.models.layers import apply_rope, dense_init

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
                   page_table: Optional[torch.Tensor] = None,
                   live_pages: Optional[int] = None,
                   paged_kernel: str = "auto",
                   bf16_scores: bool = False):
    """Self-attention over x (B, S, d) -> (out, cache).

    cache=None: attend over the S new tokens; returns their K/V.
    Dense cache: with an int cache_pos (prefill) the new K/V go to
    positions cache_pos onwards and the tokens attend over the cache up to
    their end; with per-lane (B,) depths (decode, S == 1) each lane writes
    at its depth and attends over the whole cache, causally masked.
    Paged decode (page_table given): cache holds one layer's page pools,
    cache_pos the per-lane (B,) int32 depths, S == 1.
    `ops.paged_decode_attention` (the CUDA kernel, or its plain bounded
    gather for CPU tensors) writes the new row into the pools in place and
    attends over each lane's positions <= its depth within the leading
    `live_pages` pages.
    """
    s = x.shape[1]
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
        lanes = torch.arange(x.shape[0], device=x.device)
        pos = cache_pos.long().clamp(0, cache["k"].shape[1] - 1)
        cache["k"][lanes, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][lanes, pos] = v_new[:, 0].to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        kv_pos = torch.arange(k.shape[1], device=x.device)
    else:
        end = cache_pos + s
        cache["k"][:, cache_pos:end] = k_new.to(cache["k"].dtype)
        cache["v"][:, cache_pos:end] = v_new.to(cache["v"].dtype)
        k, v = cache["k"][:, :end], cache["v"][:, :end]
        kv_pos = torch.arange(end, device=x.device)

    o = attend_direct(q, repeat_kv(k, n_heads), repeat_kv(v, n_heads),
                      q_pos, kv_pos, causal, window, bf16_scores=bf16_scores)
    out = _out(o, p.wo)
    if cache is None:
        return out, {"k": k_new, "v": v_new}
    return out, cache
