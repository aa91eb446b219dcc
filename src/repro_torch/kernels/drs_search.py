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
fx (M, k), fw (k, F) -> (M, F / block) f32, in one pass.  Three kernels,
picked by `scores_plan` from dtype and shape: in bf16, M <= 16 (the
refresh step) a GEMV streaming fw once with 16-byte loads, each group's
columns split across a cluster whose rank 0 sums the slices' partial group
sums in rank order; larger M (admission) wgmma tiles, fw's 128-column slab
the MN-major B operand, ReLU and the group sums on the accumulator
fragments; f32 and groups that do not tile 128 columns a SIMT kernel.
`drs_scores_split_plain` is the GEMV's column-slice decomposition in plain
PyTorch.

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
SCORES_TC_COLS = 128   # kScoresTile: fw columns of a wgmma scores block
SCORES_TC_BLOCKS = (8, 16, 32, 64, 128)   # groups that tile those columns
SCORES_SMEM_LIMIT = 227 * 1024            # dynamic shared memory a block


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


class ScoresPlan(NamedTuple):
    path: str      # "gemv", "tc" or "simt"
    slices: int    # gemv: column slices of a group (the cluster size)
    per: int       # tc: 64-row tiles each block walks
    blocks: int    # blocks of the launch
    smem: int      # dynamic shared memory of a block, bytes


def scores_gemv_smem(m: int, k: int, block: int, slices: int) -> int:
    """fx's rows staged, and the four warps' partial sums of the slice."""
    return m * k * 2 + 4 * m * (block // slices) * 4


def scores_tc_smem(k: int, per: int) -> int:
    """fw's (k x 128) slab and min(2, per) stages of a 64-row fx tile."""
    return (2 + min(2, per)) * -(-k // 64) * TC_TILE * TC_TILE * 2 + 1024


def scores_plan(m: int, k: int, f: int, block: int, dtype) -> ScoresPlan:
    """The kernel for fx (m, k) @ fw (k, f) summed over `block`-wide groups:
    in bf16 the GEMV for m <= 16, with the fewest column slices of a group
    (a power of two up to 8, each a power of two of at least 8 columns)
    that give 132 blocks; the wgmma tiles for larger m, one 64-row tile a
    block where the blocks fit in one wave at two an SM, else the fewest
    row tiles a block that fit one wave at one an SM (the sweep in
    chip_smoke.py's phase 9); the SIMT kernel in f32 and for groups the
    bf16 kernels do not tile.  bf16 rows must be 16-byte
    multiples (k and f multiples of 8): raises otherwise."""
    groups = f // block
    if dtype == torch.bfloat16:
        if k % 8 or f % 8:
            raise ValueError(f"drs_scores: the bf16 kernels need k and F "
                             f"that are multiples of 8, got k={k}, F={f}")
        allowed = [s for s in (1, 2, 4, 8)
                   if block >= 8 and block & (block - 1) == 0
                   and 8 <= block // s <= 256]
        if m <= GEMV_MAX_M and allowed:
            slices = next(
                (s for s in allowed if s * groups >= SM_COUNT), allowed[-1])
            smem = scores_gemv_smem(m, k, block, slices)
            if smem <= SCORES_SMEM_LIMIT:
                return ScoresPlan("gemv", slices, 0, slices * groups, smem)
        if m > GEMV_MAX_M and block in SCORES_TC_BLOCKS \
                and scores_tc_smem(k, 2) <= SCORES_SMEM_LIMIT:
            cols, tiles = -(-f // SCORES_TC_COLS), -(-m // TC_TILE)
            per = 1
            if cols * tiles > 2 * SM_COUNT:
                per = next((p for p in range(2, tiles + 1)
                            if cols * -(-tiles // p) <= SM_COUNT), tiles)
            return ScoresPlan("tc", 0, per, cols * -(-tiles // per),
                              scores_tc_smem(k, per))
    rows = min(MAX_ROWS, m, SMEM_LIMIT // (4 * (k + block)))
    return ScoresPlan("simt", 0, 0,
                      groups * -(-m // rows) if rows >= 1 else 0,
                      4 * rows * (k + block))


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


def drs_scores_split_plain(fx, fw, *, block: int = 128, slices: int = 1):
    """The GEMV's decomposition in plain PyTorch: each group's columns in
    `slices` runs, each run's f32 products ReLU'd and summed to a partial
    group score, the partials summed in slice order."""
    v = torch.relu(fx.float() @ fw.float())
    m, f = v.shape
    v = v.reshape(m, f // block, slices, block // slices).sum(dim=-1)
    out = 0.0
    for s in range(slices):
        out = out + v[..., s]
    return out


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
    """Launch the CUDA kernel that `scores_plan` picks (CUDA tensors only;
    raises otherwise).  The bf16 paths raise unless fx and fw start on
    16-byte boundaries.  `launches` counts every call; `launches_gemv`,
    `launches_tc` and `launches_simt` those of each path."""
    name = "drs_scores"
    dev = cuda_lib.require_cuda(name, fx, fw)
    code = cuda_lib.dtype_code(name, fx, fw)
    cuda_lib.require_contiguous(name, fx=fx, fw=fw)
    m, k = fx.shape
    f = fw.shape[1]
    if fw.shape != (k, f) or f % block or not 0 < block <= 1024:
        raise ValueError(f"{name}: fx {tuple(fx.shape)}, fw "
                         f"{tuple(fw.shape)}, block {block} do not fit")
    p = scores_plan(m, k, f, block, fx.dtype)
    if p.path == "simt" and p.blocks < 1:
        raise ValueError(f"{name}: k={k} needs more shared memory than "
                         f"{SMEM_LIMIT} bytes")
    if p.path != "simt":
        cuda_lib.require_aligned16(name, fx=fx, fw=fw)
    out = torch.empty((m, f // block), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        if p.path == "gemv":
            cuda_lib.launch("repro_drs_scores_gemv", fx.data_ptr(),
                            fw.data_ptr(), out.data_ptr(), m, k, f, block,
                            p.slices, cuda_lib.stream(dev))
            drs_scores.launches_gemv += 1
        elif p.path == "tc":
            cuda_lib.launch("repro_drs_scores_tc", fx.data_ptr(),
                            fw.data_ptr(), out.data_ptr(), m, k, f, block,
                            p.per, cuda_lib.stream(dev))
            drs_scores.launches_tc += 1
        else:
            rows = p.smem // (4 * (k + block))
            cuda_lib.launch("repro_drs_scores", code, fx.data_ptr(),
                            fw.data_ptr(), out.data_ptr(), m, k, f, block,
                            rows, p.smem, cuda_lib.stream(dev))
            drs_scores.launches_simt += 1
    drs_scores.launches += 1
    return out


drs_scores.launches = 0
drs_scores.launches_gemv = 0
drs_scores.launches_tc = 0
drs_scores.launches_simt = 0
