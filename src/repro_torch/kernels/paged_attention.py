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

Two kernels, picked by `plan` from dtype and shape (never on failure): in
bf16 with D in {64, 128, 256}, g = H / Kv a power of two with
128 <= g * D <= 1024 and pages of at most 32 rows, the split kernel
shares each (lane, kv head)'s page walk among a cluster of blocks and
merges their (m, l, acc) in rank order; f32 and other shapes take the
serial kernel.  `paged_split_plain` is the split decomposition in plain
PyTorch.

A lane's output is a function of its own operands and of the plan's
constants alone: the split kernel cuts a lane's walk of n pages into runs
of ceil(n / MAX_SPLITS) pages, whatever the other lanes hold, the batch
size or the walk bound (which the batch's deepest lane and a fused
chunk's span set).  The walk bound sizes the grid only.  The serial
kernel walks each lane's pages in order.

Bound on the H100: bytes (see the source note in the .cu file).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import cuda_lib

NEG = -1e30
THREADS = 128           # the serial kernel's threads
SMEM_LIMIT = 48 * 1024  # the serial kernel's shared memory
SPLIT_THREADS = 128     # kSplitThreads in paged_attention.cu
SPLIT_STAGES = 3        # kSplitStages: pages in flight per split
SPLIT_MAX_EPT = 8       # kMaxEpt: g * D <= SPLIT_THREADS * SPLIT_MAX_EPT
MAX_SPLITS = 8          # the portable cluster size
SPLIT_SMEM_LIMIT = 232448


class Plan(NamedTuple):
    path: str    # "split" or "serial"
    splits: int  # blocks per (lane, kv head), one cluster
    blocks: int
    smem: int    # dynamic shared memory of a block, bytes


def split_smem(g: int, d: int, ps: int) -> int:
    """The split kernel's shared memory: the page ring in bf16, then q,
    the split's acc, the score tile and three per-head statistics in f32."""
    return SPLIT_STAGES * 2 * ps * d * 2 + 4 * (2 * g * d + g * ps + 3 * g)


def split_grid(splits: int, walk: int) -> int:
    """Blocks per (lane, kv head) of the split kernel: the walk rounded up
    to a power of two, at most `splits` (a lane of n <= walk pages cut
    into runs of ceil(n / splits) pages has at most that many runs)."""
    grid = 1
    while grid < walk and grid < splits:
        grid *= 2
    return min(grid, splits)


def plan(b: int, kv: int, g: int, d: int, ps: int, walk: int, dtype) -> Plan:
    """The kernel and its split count for one decode step of `walk` pages.
    The split kernel cuts every lane's walk MAX_SPLITS ways, a constant, so
    that no lane's sums depend on the batch or the walk; `blocks` counts
    the grid the walk sizes."""
    smem = split_smem(g, d, ps)
    if (dtype != torch.bfloat16 or d not in (64, 128, 256) or g & (g - 1)
            or not SPLIT_THREADS <= g * d <= SPLIT_THREADS * SPLIT_MAX_EPT
            or not 1 <= ps <= 32 or smem > SPLIT_SMEM_LIMIT):
        return Plan("serial", 1, b * kv,
                    4 * (2 * g * d + 2 * ps * d + g * ps + 3 * g))
    return Plan("split", MAX_SPLITS,
                b * kv * split_grid(MAX_SPLITS, walk), smem)


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


def paged_split_plain(q, k_new, v_new, k_pages, v_pages, page_table, pos, *,
                      window: int = 0, num_pages: int = 0, splits: int = 1):
    """The split kernel's decomposition in plain PyTorch: each lane's walk
    of n = min(pos // ps, walk - 1) + 1 pages cut into contiguous runs of
    ceil(n / splits) pages, one for each of the grid's split_grid(splits,
    walk) blocks (later runs may be empty); each run's f32 (m, l, acc),
    m = -1e30, l = 0, acc = 0 for a run that holds no unmasked position;
    merged in run order and divided by max(l, 1e-20).  A lane's cut
    depends on its n and `splits` alone; the empty runs a wider walk adds
    merge as exact zeros.  Returns (o, k_pages, v_pages) with the pools
    updated in place."""
    b, h, d = q.shape
    ps, kv = k_pages.shape[1], k_pages.shape[2]
    max_pages = page_table.shape[1]
    walk = _walk(num_pages, max_pages)
    pt = page_table.long()
    pos_l = pos.long()
    lp = pos_l // ps
    inside = lp < walk
    lanes = torch.arange(b, device=q.device)
    pp = pt[lanes, lp.clamp(max=max_pages - 1)]
    off = pos_l % ps
    k_pages[pp[inside], off[inside]] = k_new[inside].to(k_pages.dtype)
    v_pages[pp[inside], off[inside]] = v_new[inside].to(v_pages.dtype)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    for lane in range(b):
        p = int(pos_l[lane])
        n = min(p // ps, walk - 1) + 1
        per = -(-n // splits)
        qf = q[lane].float()                                   # (H, D)
        m_all, l_all, acc_all = [], [], []
        for s in range(split_grid(splits, walk)):
            j0, j1 = min(n, s * per), min(n, s * per + per)
            t = torch.arange(j0 * ps, j1 * ps, device=q.device)
            k = k_pages[pt[lane, t // ps], t % ps].float()     # (T, Kv, D)
            v = v_pages[pt[lane, t // ps], t % ps].float()
            k = k.repeat_interleave(h // kv, 1)
            v = v.repeat_interleave(h // kv, 1)
            sc = torch.einsum("hd,thd->ht", qf, k) * scale
            valid = t <= p
            if window > 0:
                valid &= t > p - window
            sc = torch.where(valid, sc, NEG)
            m = sc.amax(dim=-1) if t.numel() else torch.full(
                (h,), NEG, device=q.device)
            pr = torch.exp(sc - m[:, None]) * valid
            m_all.append(m)
            l_all.append(pr.sum(dim=-1))
            acc_all.append(torch.einsum("ht,thd->hd", pr, v))
        mx = torch.stack(m_all).amax(dim=0)
        l_sum = acc = 0.0
        for m, l_s, a in zip(m_all, l_all, acc_all):
            w = torch.exp(m - mx)
            l_sum = l_sum + l_s * w
            acc = acc + a * w[:, None]
        out[lane] = (acc / l_sum.clamp_min(1e-20)[:, None]).to(q.dtype)
    return out, k_pages, v_pages


def paged_decode(q, k_new, v_new, k_pages, v_pages, page_table, pos, *,
                 window: int = 0, num_pages: int = 0):
    """Launch the CUDA kernel that `plan` picks (CUDA tensors only; raises
    otherwise).  The split kernel raises unless k_new, v_new and the pools
    start on 16-byte boundaries.  Returns (o, k_pages, v_pages) with the
    pools updated in place.  `launches` counts every call;
    `launches_split` and `launches_serial` those of each kernel."""
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
    walk = _walk(num_pages, max_pages)
    p = plan(b, kv, g, d, ps, walk, q.dtype)
    out = torch.empty_like(q)
    if p.path == "split":
        cuda_lib.require_aligned16(name, k_new=k_new, v_new=v_new,
                                   k_pages=k_pages, v_pages=v_pages)
        with torch.cuda.device(dev):
            cuda_lib.launch(
                "repro_paged_decode_split", q.data_ptr(), k_new.data_ptr(),
                v_new.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, kv,
                g, d, ps, max_pages, walk, window, 1.0 / math.sqrt(d),
                p.splits, cuda_lib.stream(dev))
        cuda_lib.count(paged_decode, "split")
    else:
        if p.smem > SMEM_LIMIT:
            raise ValueError(f"{name}: {p.smem} bytes of shared memory "
                             f"needed (g={g}, ps={ps}, D={d}), limit "
                             f"{SMEM_LIMIT}")
        with torch.cuda.device(dev):
            cuda_lib.launch(
                "repro_paged_decode", code, q.data_ptr(), k_new.data_ptr(),
                v_new.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, kv,
                g, d, ps, max_pages, walk, window, 1.0 / math.sqrt(d),
                THREADS, p.smem, cuda_lib.stream(dev))
        cuda_lib.count(paged_decode, "serial")
    return out, k_pages, v_pages


paged_decode.launches = 0
paged_decode.launches_split = 0
paged_decode.launches_serial = 0
