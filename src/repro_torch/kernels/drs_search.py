"""DRS search: the CUDA kernels `csrc/drs_search.cu` (replacing the Pallas
`repro/kernels/drs_search.py::drs_project` and `::drs_scores`) and their
plain PyTorch versions.

drs_project: f(X) = X @ R^T, x (M, d), r (k, d) -> (M, k) in x's dtype
with f32 accumulation.  Unlike the Pallas kernel, any M is taken.  Three
kernels, picked by `project_plan` from dtype and shape (never on failure):
in bf16, M <= 16 (the refresh step) takes a GEMV with x staged in shared
memory, and larger M (admission) wgmma tiles with d split across blocks
and the splits summed in order; f32 takes a SIMT tile.
`drs_project_split_plain` is the split-d decomposition in plain PyTorch.
drs_scores: relu(fx @ fw) summed over each `block`-wide group,
fx (M, k), fw (k, F) -> (M, F / block) f32, in one pass.

Bound on the H100: bytes for both (see the source note in the .cu file).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import cuda_lib

MAX_ROWS = 16          # kMaxRows in drs_search.cu
SMEM_LIMIT = 48 * 1024
SM_COUNT = 132         # H100 SXM
GEMV_MAX_M = 16        # kGemvMaxM in drs_search.cu
GEMV_WARPS = 4         # kGemvWarps: warps per GEMV block
GEMV_MAX_SMEM = 160 * 1024   # x staged in shared memory: m * d * 2 bytes
MIN_WARPS = 128        # the GEMV splits rows until this many warps run
TC_TILE = 64           # output tile and d chunk of the wgmma kernel


class ProjectPlan(NamedTuple):
    path: str              # "gemv", "tc" or "simt"
    splits: int            # gemv: warps per R row; tc: d splits
    chunks_per_split: int  # tc: TC_TILE-wide chunks of d per split
    blocks: int            # blocks of the main launch
    warps: int             # warps of the main launch


def project_plan(m: int, k: int, d: int, dtype) -> ProjectPlan:
    """The kernel and its split of d for x (m, d) @ r (k, d)^T."""
    if dtype != torch.bfloat16 or d % 8:
        blocks = -(-k // 16) * -(-m // 16)
        return ProjectPlan("simt", 1, 0, blocks, blocks * 8)
    if m <= GEMV_MAX_M and m * d * 2 <= GEMV_MAX_SMEM:
        shares = next(s for s in (1, 2, 4) if k * s >= MIN_WARPS or s == 4)
        blocks = -(-k * shares // GEMV_WARPS)
        return ProjectPlan("gemv", shares, 0, blocks, blocks * GEMV_WARPS)
    tiles = -(-m // TC_TILE) * -(-k // TC_TILE)
    chunks = -(-d // TC_TILE)
    want = 1 if tiles >= SM_COUNT else -(-SM_COUNT // tiles)
    per = -(-chunks // min(want, chunks))
    splits = -(-chunks // per)
    return ProjectPlan("tc", splits, per, tiles * splits, tiles * splits * 4)


def drs_project_plain(x, r):
    return (x.float() @ r.float().t()).to(x.dtype)


def drs_project_split_plain(x, r, *, chunks_per_split: int,
                            chunk: int = TC_TILE):
    """The wgmma kernel's split-d decomposition in plain PyTorch: f32
    partial products over runs of `chunks_per_split` chunks of `chunk`
    columns of d, summed in split order and rounded once to x's dtype."""
    d = x.shape[1]
    step = chunk * chunks_per_split
    out = 0.0
    for c0 in range(0, d, step):
        out = out + x[:, c0:c0 + step].float() @ r[:, c0:c0 + step].float().t()
    return out.to(x.dtype)


def drs_scores_plain(fx, fw, *, block: int = 128):
    v = fx.float() @ fw.float()
    m, f = v.shape
    return torch.relu(v).reshape(m, f // block, block).sum(dim=-1)


def drs_project(x, r):
    """Launch the CUDA kernel that `project_plan` picks (CUDA tensors only;
    raises otherwise).  The bf16 paths raise unless x and r start on
    16-byte boundaries.  `launches` counts every call; `launches_gemv`,
    `launches_tc` and `launches_simt` those of each path."""
    name = "drs_project"
    dev = cuda_lib.require_cuda(name, x, r)
    code = cuda_lib.dtype_code(name, x, r)
    cuda_lib.require_contiguous(name, x=x, r=r)
    m, d = x.shape
    k = r.shape[0]
    if r.shape != (k, d):
        raise ValueError(f"{name}: x {tuple(x.shape)} and r "
                         f"{tuple(r.shape)} disagree on d")
    p = project_plan(m, k, d, x.dtype)
    if p.path != "simt":
        cuda_lib.require_aligned16(name, x=x, r=r)
    out = torch.empty((m, k), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        if p.path == "gemv":
            cuda_lib.launch("repro_drs_project_gemv", x.data_ptr(),
                            r.data_ptr(), out.data_ptr(), m, k, d, p.splits,
                            cuda_lib.stream(dev))
            drs_project.launches_gemv += 1
        elif p.path == "tc":
            ws = out                               # read only when split
            if p.splits > 1:
                ws = torch.empty((p.splits, m, k), dtype=torch.float32,
                                 device=dev)
            cuda_lib.launch("repro_drs_project_tc", x.data_ptr(),
                            r.data_ptr(), out.data_ptr(), ws.data_ptr(), m, k,
                            d, p.chunks_per_split, p.splits,
                            cuda_lib.stream(dev))
            drs_project.launches_tc += 1
        else:
            cuda_lib.launch("repro_drs_project", code, x.data_ptr(),
                            r.data_ptr(), out.data_ptr(), m, k, d,
                            cuda_lib.stream(dev))
            drs_project.launches_simt += 1
    drs_project.launches += 1
    return out


drs_project.launches = 0
drs_project.launches_gemv = 0
drs_project.launches_tc = 0
drs_project.launches_simt = 0


def drs_scores(fx, fw, *, block: int = 128):
    """Launch the CUDA kernel (CUDA tensors only; raises otherwise)."""
    name = "drs_scores"
    dev = cuda_lib.require_cuda(name, fx, fw)
    code = cuda_lib.dtype_code(name, fx, fw)
    cuda_lib.require_contiguous(name, fx=fx, fw=fw)
    m, k = fx.shape
    f = fw.shape[1]
    if fw.shape != (k, f) or f % block or not 0 < block <= 1024:
        raise ValueError(f"{name}: fx {tuple(fx.shape)}, fw "
                         f"{tuple(fw.shape)}, block {block} do not fit")
    rows = min(MAX_ROWS, m, SMEM_LIMIT // (4 * (k + block)))
    if rows < 1:
        raise ValueError(f"{name}: k={k} needs more shared memory than "
                         f"{SMEM_LIMIT} bytes")
    out = torch.empty((m, f // block), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        cuda_lib.launch("repro_drs_scores", code, fx.data_ptr(),
                        fw.data_ptr(), out.data_ptr(), m, k, f, block, rows,
                        4 * rows * (k + block), cuda_lib.stream(dev))
    drs_scores.launches += 1
    return out


drs_scores.launches = 0
