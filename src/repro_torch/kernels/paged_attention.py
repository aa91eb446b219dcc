"""Paged-attention decode step: the CUDA kernel `csrc/paged_attention.cu`
(replacing the Pallas `repro/kernels/paged_attention.py::paged_decode`)
and its plain PyTorch version.

Layout (one layer's slice of the paged backend):

    q            (B, H, D)        the step's queries, RoPE applied
    k_new/v_new  (B, Kv, D)       the new token's K/V
    k_pages/v_pages (P, ps, Kv, D) physical page pools, updated IN PLACE
    page_table   (B, max_pages)   int32 logical -> physical page
    pos          (B,)             int32 per-lane write position

The new token's K/V is written to row pos % ps of logical page pos // ps,
and each lane attends over positions t <= pos (and t > pos - window for a
sliding window) of pages 0..min(pos // ps, walk - 1), where
walk = min(num_pages, max_pages) (0 = max_pages).  A lane whose write page
lies beyond the walk (an undersized bound, a caller bug) writes nothing and
attends over the truncated window.  Where JAX returns new pools, the port
writes into the pools it is given and returns them.

Bound on the H100: bytes (see the source note in the .cu file).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda_lib

NEG = -1e30
THREADS = 128
SMEM_LIMIT = 48 * 1024


def _walk(num_pages: int, max_pages: int) -> int:
    return min(num_pages, max_pages) if num_pages else max_pages


def paged_decode_plain(q, k_new, v_new, k_pages, v_pages, page_table, pos, *,
                       window: int = 0, num_pages: int = 0):
    """Plain PyTorch version: scatter the new rows, gather the walked
    window, masked softmax with f32 scores.  Returns (o, k_pages, v_pages)
    with the pools updated in place."""
    b, h, d = q.shape
    ps, kv = k_pages.shape[1], k_pages.shape[2]
    max_pages = page_table.shape[1]
    walk = _walk(num_pages, max_pages)
    pt = page_table.long()
    pos = pos.long()
    lanes = torch.arange(b, device=q.device)
    lp = pos // ps
    inside = lp < walk
    pp = pt[lanes, lp.clamp(max=max_pages - 1)]
    off = pos % ps
    k_pages[pp[inside], off[inside]] = k_new[inside].to(k_pages.dtype)
    v_pages[pp[inside], off[inside]] = v_new[inside].to(v_pages.dtype)
    t = torch.arange(walk * ps, device=q.device)
    k = k_pages[pt[:, t // ps], t % ps].float().repeat_interleave(h // kv, 2)
    v = v_pages[pt[:, t // ps], t % ps].float().repeat_interleave(h // kv, 2)
    s = torch.einsum("bhd,bthd->bht", q.float(), k) * (1.0 / math.sqrt(d))
    valid = t[None, None, :] <= pos[:, None, None]
    if window > 0:
        valid &= t[None, None, :] > (pos[:, None, None] - window)
    s = torch.where(valid, s, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    o = torch.einsum("bht,bthd->bhd", p, v)
    o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return o.to(q.dtype), k_pages, v_pages


def paged_decode(q, k_new, v_new, k_pages, v_pages, page_table, pos, *,
                 window: int = 0, num_pages: int = 0):
    """Launch the CUDA kernel (CUDA tensors only; raises otherwise).
    Returns (o, k_pages, v_pages) with the pools updated in place."""
    name = "paged_decode"
    dev = cuda_lib.require_cuda(name, q, k_new, v_new, k_pages, v_pages,
                                page_table, pos)
    code = cuda_lib.dtype_code(name, q, k_new, v_new, k_pages, v_pages)
    cuda_lib.require_contiguous(name, q=q, k_new=k_new, v_new=v_new,
                                k_pages=k_pages, v_pages=v_pages,
                                page_table=page_table, pos=pos)
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"{name}: page_table and pos must be int32")
    b, h, d = q.shape
    n_p, ps, kv, d2 = k_pages.shape
    if (h % kv or d2 != d or v_pages.shape != k_pages.shape
            or k_new.shape != (b, kv, d) or v_new.shape != (b, kv, d)
            or page_table.dim() != 2 or page_table.shape[0] != b
            or pos.shape != (b,)):
        raise ValueError(f"{name}: inconsistent shapes q {tuple(q.shape)}, "
                         f"k_new {tuple(k_new.shape)}, pools "
                         f"{tuple(k_pages.shape)}, page_table "
                         f"{tuple(page_table.shape)}, pos {tuple(pos.shape)}")
    g = h // kv
    max_pages = page_table.shape[1]
    smem = 4 * (2 * g * d + 2 * ps * d + g * ps + 3 * g)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {smem} bytes of shared memory needed "
                         f"(g={g}, ps={ps}, D={d}), limit {SMEM_LIMIT}")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        cuda_lib.launch(
            "repro_paged_decode", code, q.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, kv, g,
            d, ps, max_pages, _walk(num_pages, max_pages), window,
            1.0 / math.sqrt(d), THREADS, smem, cuda_lib.stream(dev))
    paged_decode.launches += 1
    return out, k_pages, v_pages


paged_decode.launches = 0
