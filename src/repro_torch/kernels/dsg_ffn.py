"""Group-sparse SwiGLU FFN: the CUDA kernels of `csrc/dsg_ffn.cu` and their
plain PyTorch versions.

dsg_ffn_csr (replacing the Pallas `repro/kernels/dsg_ffn.py::dsg_ffn_csr`),
the group-CSR decode step: x (B, d) holds one token per lane, wg/wu
(d, F), wd (F, d), idx (B, K) the lane's active group indices (ascending,
zero-padded past counts), counts (B,) -> (B, d) in x's dtype.  Only the
listed groups' weight blocks are read.  Two paths, picked by `csr_plan`
from dtype and shape (never on failure): in bf16 with up to 8 lanes the
union path reads each group that some lane lists once for all lanes
(gate/up by clusters that split d, the down projection by column tile and
group split, each summed in rank order through distributed shared
memory); f32, more lanes and other shapes take the per-lane kernels.
`csr_union_plain` is the union path's decomposition in plain PyTorch.

dsg_ffn (replacing the Pallas `repro/kernels/dsg_ffn.py::dsg_ffn`), the
tile-masked FFN over multi-token rows: x (M, d), token_mask (M, F / block)
{0, 1} -> (M, d) in x's dtype.  A (token tile x hidden block) cell that no
token of the tile selected is skipped; live cells re-apply the per-token
mask, so the output is the per-token masked FFN whatever cells are
skipped.  Two paths, picked by `tile_plan` from dtype and shape: in bf16
with d % 64 == 0 and F % 128 == 0 wgmma tiles fed by TMA through a
producer warp's ring (cells of 64 or 128 rows x 128 columns; the down
projection split over F across a cluster, summed in rank order), else
SIMT tiles (cells of 64 x 64).  `tile_skip_fraction` counts the dead cells of the
reference's (bm, bf) tiling, `cell_skip_fraction` those of any cells (the
plan's own); `dsg_ffn_split_plain` is the tensor-core path's F-split
decomposition in plain PyTorch.

Both round h = silu(x . wg) * (x . wu) to x's dtype before the down
projection, as in the reference; the down projection then accumulates in
f32 and rounds once, where the Pallas kernels round their accumulator to
x's dtype after every slot or F block.  In f32 the two agree to summation
order; in bf16 the port's output is the more accurate one and differs from
the reference by up to about one bf16 ulp per slot or F block added.

Bound on the H100: bytes (see the source note in the .cu file).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_lib

GATE_UP_THREADS = 512   # kGateUpThreads in dsg_ffn.cu; block must divide it
TILE = 64               # kTM = kTN in dsg_ffn.cu: the SIMT tile's cells
TC_ROWS, TC_COLS = 64, 128   # tensor-core path: down-block rows, cell columns
TC_MAX_CHUNKS = 1024    # kMaxChunks: F / 128 the tensor-core path takes
TC_STAGES = 4           # kFfnStages: ring stages of the tensor-core path
SMEM_LIMIT = 48 * 1024  # the lanes path's shared memory
SM_COUNT = 132          # H100 SXM
UNION_THREADS = 256     # kThreads: threads of the union path's blocks
UNION_STAGES = 8        # kStages: ring slots a thread, 7 copies in flight
UNION_MAX_LANES = 8
UNION_MAX_GROUPS = 1024  # kMaxGroups
# dynamic shared memory a union block may take: the 227 KB of one H100
# block less the static shared memory of the union lists (8 KB and a few
# words)
UNION_SMEM_LIMIT = 232448 - 8 * UNION_MAX_GROUPS - 64


class CsrPlan(NamedTuple):
    path: str              # "union" or "lanes"
    lanes: int             # union: lanes the kernels compute, a power of 2 >= B
    max_union: int         # union entries the gate/up grid covers: min(G, B K)
    cluster: int           # gate/up: blocks splitting d per (group, slice)
    slice: int             # gate/up: columns of a group per block
    tile: int              # down: output columns per block
    splits: int            # down: group splits per column tile
    gate_up_blocks: int
    down_blocks: int


def union_smem(lanes: int, d: int, block: int, max_union: int, cluster: int,
               slice_: int, tile: int, splits: int) -> tuple:
    """Dynamic shared memory of the union path's (gate/up, down) blocks, as
    `csr_union` in dsg_ffn.cu sizes it."""
    ring = max(UNION_THREADS * 16 * UNION_STAGES, UNION_THREADS * lanes * 32)
    up = ring + 4 * lanes * (2 * slice_ + -(-d // (8 * cluster)) * 8)
    down = (ring + 4 * lanes * tile
            + 4 * (lanes + 1) * -(-max_union // splits) * block)
    return up, down


def _pow2_at_least(n: int, cap: int) -> int:
    p = 1
    while p < n and p < cap:
        p *= 2
    return p


def csr_plan(b: int, d: int, f: int, k: int, block: int, dtype) -> CsrPlan:
    """The path of the group-CSR FFN for x (b, d), wg (d, f), idx (b, k),
    and the union path's cluster and split sizes.  The gate/up grid covers
    min(G, b k) union entries with clusters that split d until the blocks
    fill the SMs; the down projection takes 128-column tiles where 8
    splits of them fill the SMs, else 64-column tiles, with group splits
    until the blocks fill the SMs."""
    groups = f // block if block > 0 else 0
    max_union = min(groups, b * k)
    lanes = _pow2_at_least(b, UNION_MAX_LANES)
    slice_ = min(128, block)
    tile = 128 if d % 128 == 0 and d // 128 * 8 >= SM_COUNT else 64
    units = max(1, max_union) * max(1, block // slice_)
    cluster = _pow2_at_least(-(-SM_COUNT // units), 8)
    tiles = d // tile
    splits = _pow2_at_least(-(-SM_COUNT // max(1, tiles)), 8)
    plan = CsrPlan("union", lanes, max_union, cluster, slice_, tile, splits,
                   max_union * (block // max(1, slice_)) * cluster,
                   tiles * splits)
    fits = (dtype == torch.bfloat16 and 1 <= b <= UNION_MAX_LANES
            and block >= 32 and block % 32 == 0 and f % block == 0
            and groups <= UNION_MAX_GROUPS and d >= 64 and d % 64 == 0
            and max(union_smem(lanes, d, block, max_union, cluster, slice_,
                               tile, splits)) <= UNION_SMEM_LIMIT)
    if fits:
        return plan
    return plan._replace(path="lanes", lanes=b, cluster=1, splits=1,
                         gate_up_blocks=b * k,
                         down_blocks=b * -(-d // 64))


def dsg_ffn_csr_plain(x, wg, wu, wd, idx, counts, *, block: int = 128):
    """Plain PyTorch version: gather each lane's listed column blocks,
    SwiGLU in f32, h rounded to x's dtype, zero the padded slots, down
    projection accumulated in f32.  Padded slots (j >= counts) read group 0
    in place of whatever they hold, so padding of any value is ignored."""
    b, d = x.shape
    k = idx.shape[1]
    valid = torch.arange(k, device=x.device) < counts[:, None]
    cols = (torch.where(valid, idx, 0).long()[..., None] * block
            + torch.arange(block, device=x.device)).reshape(b, k * block)
    xf = x.float()
    g = torch.einsum("bd,bdm->bm", xf, wg[:, cols].permute(1, 0, 2).float())
    u = torch.einsum("bd,bdm->bm", xf, wu[:, cols].permute(1, 0, 2).float())
    h = (F.silu(g) * u).to(x.dtype).float()
    h = h * valid.repeat_interleave(block, dim=1)
    return torch.einsum("bm,bmd->bd", h, wd[cols].float()).to(x.dtype)


def csr_union(idx, counts, groups: int):
    """The ascending union of the groups the lanes list in slots
    j < counts[b] (the zero padding adds nothing), and a (B, U) bool of
    which lanes list each union group."""
    b, k = idx.shape
    valid = torch.arange(k, device=idx.device) < counts[:, None].long()
    listed = torch.zeros((b, groups), dtype=torch.bool, device=idx.device)
    lane = torch.arange(b, device=idx.device)[:, None].expand(b, k)
    listed[lane[valid], idx.long()[valid]] = True
    ulist = torch.nonzero(listed.any(dim=0)).flatten()
    return ulist, listed[:, ulist]


def csr_union_plain(x, wg, wu, wd, idx, counts, *, block: int = 128,
                    cluster: int = 1, splits: int = 1):
    """The union path's decomposition in plain PyTorch: the union of the
    lanes' groups read once; gate and up as f32 partial products over d
    split `cluster` ways (runs of a multiple of 8 rows), summed in rank
    order; h rounded to x's dtype and zeroed for the lanes that do not list
    a group; the down projection as f32 partials over `splits` contiguous
    runs of the ascending union, summed in split order and rounded once.
    Output columns are independent, so the kernel's column tiles change
    nothing here."""
    b, d = x.shape
    ulist, lists = csr_union(idx, counts, wg.shape[1] // block)
    n = ulist.numel()
    if n == 0:
        return torch.zeros_like(x)
    cols = (ulist[:, None] * block
            + torch.arange(block, device=x.device)).flatten()
    xf = x.float()
    per = -(-d // (8 * cluster)) * 8
    g = u = 0.0
    for r0 in range(0, d, per):
        g = g + xf[:, r0:r0 + per] @ wg[r0:r0 + per, cols].float()
        u = u + xf[:, r0:r0 + per] @ wu[r0:r0 + per, cols].float()
    h = (F.silu(g) * u).to(x.dtype).float().reshape(b, n, block)
    h = h * lists[..., None]
    per = -(-n // splits)
    out = 0.0
    for u0 in range(0, n, per):
        out = out + (h[:, u0:u0 + per].reshape(b, -1)
                     @ wd[cols[u0 * block:(u0 + per) * block]].float())
    return out.to(x.dtype)


def dsg_ffn_csr(x, wg, wu, wd, idx, counts, *, block: int = 128):
    """Launch the CUDA kernels that `csr_plan` picks (CUDA tensors only;
    raises otherwise).  The union path raises unless x, wg, wu and wd
    start on 16-byte boundaries.  `launches` counts every call; `launches_union`
    and `launches_lanes` those of each path."""
    name = "dsg_ffn_csr"
    dev = cuda_lib.require_cuda(name, x, wg, wu, wd, idx, counts)
    code = cuda_lib.dtype_code(name, x, wg, wu, wd)
    cuda_lib.require_contiguous(name, x=x, wg=wg, wu=wu, wd=wd, idx=idx,
                                counts=counts)
    if idx.dtype != torch.int32 or counts.dtype != torch.int32:
        raise ValueError(f"{name}: idx and counts must be int32")
    b, d = x.shape
    f = wg.shape[1]
    k = idx.shape[1]
    if (wg.shape != (d, f) or wu.shape != (d, f) or wd.shape != (f, d)
            or idx.shape != (b, k) or counts.shape != (b,)
            or f % block or k > f // block):
        raise ValueError(f"{name}: inconsistent shapes x {tuple(x.shape)}, "
                         f"wg {tuple(wg.shape)}, wd {tuple(wd.shape)}, idx "
                         f"{tuple(idx.shape)}, block {block}")
    p = csr_plan(b, d, f, k, block, x.dtype)
    out = torch.empty_like(x)
    if p.path == "union":
        cuda_lib.require_aligned16(name, x=x, wg=wg, wu=wu, wd=wd)
        h = torch.empty((max(1, p.max_union), b, block), dtype=x.dtype,
                        device=dev)
        with torch.cuda.device(dev):
            cuda_lib.launch(
                "repro_dsg_ffn_csr_union", x.data_ptr(), wg.data_ptr(),
                wu.data_ptr(), wd.data_ptr(), idx.data_ptr(),
                counts.data_ptr(), h.data_ptr(), out.data_ptr(), b, d, f, k,
                block, p.lanes, p.cluster, p.slice, p.tile, p.splits,
                cuda_lib.stream(dev))
        dsg_ffn_csr.launches_union += 1
    else:
        if block > GATE_UP_THREADS or GATE_UP_THREADS % block:
            raise ValueError(f"{name}: block {block} must divide "
                             f"{GATE_UP_THREADS}")
        if 4 * (d + 2 * GATE_UP_THREADS) > SMEM_LIMIT:
            raise ValueError(f"{name}: d={d} needs more shared memory than "
                             f"{SMEM_LIMIT} bytes")
        h = torch.empty((b, k, block), dtype=x.dtype, device=dev)
        with torch.cuda.device(dev):
            cuda_lib.launch(
                "repro_dsg_ffn_csr", code, x.data_ptr(), wg.data_ptr(),
                wu.data_ptr(), wd.data_ptr(), idx.data_ptr(),
                counts.data_ptr(), h.data_ptr(), out.data_ptr(), b, d, f, k,
                block, cuda_lib.stream(dev))
        dsg_ffn_csr.launches_lanes += 1
    dsg_ffn_csr.launches += 1
    return out


dsg_ffn_csr.launches = 0
dsg_ffn_csr.launches_union = 0
dsg_ffn_csr.launches_lanes = 0


def check_tiles(m: int, f: int, block: int, bm: int, bf: int):
    """The reference's tiling contract: bm = min(bm, M) divides M,
    bf = min(bf, F) divides F and is a multiple of block.  Returns the
    clamped pair."""
    bm, bf = min(bm, m), min(bf, f)
    if bm < 1 or bf < 1 or block < 1 or m % bm or f % bf or bf % block:
        raise ValueError(f"dsg_ffn: M={m}, F={f} do not split into (bm={bm}, "
                         f"bf={bf}) cells of whole {block}-wide groups")
    return bm, bf


def tile_skip_fraction(token_mask, bm: int, bf: int, block: int) -> float:
    """Share of the (bm-token tile x bf-column block) cells that no token of
    the tile selected: the cells the tile-masked kernel skips."""
    m, g = token_mask.shape
    bm, bf = check_tiles(m, g * block, block, bm, bf)
    tile = token_mask.reshape(m // bm, bm, g * block // bf,
                              bf // block).amax(dim=(1, 3))
    return 1.0 - float((tile > 0).float().mean())


def live_cells(token_mask, block: int, rows: int, cols: int):
    """(ceil(M / rows), ceil(F / cols)) bool: the (rows x cols) cells of the
    (M, F) hidden activations that some token of the cell's rows selected
    (a group that the cell's columns touch); ragged edge cells count
    whole."""
    m, g = token_mask.shape
    f = g * block
    live = token_mask.float().repeat_interleave(block, dim=1) > 0
    live = F.pad(live, (0, -f % cols, 0, -m % rows))
    return live.reshape(-(-m // rows), rows, -(-f // cols), cols).any(
        dim=3).any(dim=1)


def cell_skip_fraction(token_mask, rows: int, cols: int,
                       block: int) -> float:
    """Share of the (rows x cols) cells that no token of the cell's rows
    selected: the cells a kernel with those cells skips."""
    return 1.0 - float(live_cells(token_mask, block, rows, cols)
                       .float().mean())


def tile_tc_smem(rows: int) -> tuple:
    """Dynamic shared memory of the tensor-core path's (gate/up, down)
    blocks, as `launch_tile_tc` sizes them: rings of 8 KB tiles (a gate/up
    stage rows // 64 of x, two of wg and two of wu; a down stage one of h
    and two of wd), which the down block's f32 partial overlays."""
    tile = 64 * 64 * 2
    return (TC_STAGES * (rows // 64 + 4) * tile + 1024,
            TC_STAGES * 3 * tile + 1024)


class TilePlan(NamedTuple):
    path: str              # "tc" or "simt"
    rows: int              # tc: token rows of a gate/up block (64 or 128)
    splits: int            # tc: F splits of the down projection (cluster)
    cell_rows: int         # the cells whose dead ones are skipped
    cell_cols: int
    gate_up_blocks: int
    down_blocks: int


def tile_plan(m: int, d: int, f: int, block: int, dtype) -> TilePlan:
    """The path of the tile-masked FFN for x (m, d), wg (d, f): bf16 with
    d % 64 == 0 and f % 128 == 0 takes the wgmma tiles: gate/up blocks of
    128 token rows (two warpgroups sharing each weight tile) unless M fits
    in 64, and down blocks of 64 rows with the most F splits (a power of
    two up to 8) that keep them within one wave of the SMs, one block an
    SM (the sweep in chip_smoke.py's phase 9); f32 and other shapes take
    the SIMT tiles.  bf16 rows must be 16-byte multiples (d and f
    multiples of 8): raises otherwise."""
    if dtype == torch.bfloat16:
        if d % 8 or f % 8:
            raise ValueError(f"dsg_ffn: the bf16 kernels need d and F that "
                             f"are multiples of 8, got d={d}, F={f}")
        if d % 64 == 0 and f % TC_COLS == 0 \
                and f // TC_COLS <= TC_MAX_CHUNKS:
            rows = 128 if m > 64 else 64
            tiles = -(-d // TC_COLS) * -(-m // TC_ROWS)
            splits = max([1] + [s for s in (2, 4, 8)
                                if tiles * s <= SM_COUNT])
            return TilePlan("tc", rows, splits, rows, TC_COLS,
                            -(-m // rows) * (f // TC_COLS), tiles * splits)
    mt = -(-m // TILE)
    return TilePlan("simt", TILE, 1, TILE, TILE, mt * -(-f // TILE),
                    mt * -(-d // TILE))


def dsg_ffn_plain(x, wg, wu, wd, token_mask, *, block: int = 128):
    """Plain PyTorch version: the full SwiGLU in f32, the per-token group
    mask applied, h rounded to x's dtype, down projection in f32."""
    m = x.shape[0]
    xf = x.float()
    h = F.silu(xf @ wg.float()) * (xf @ wu.float())
    h = (h.reshape(m, -1, block) * token_mask.float()[..., None]).reshape(
        m, -1)
    return (h.to(x.dtype).float() @ wd.float()).to(x.dtype)


def dsg_ffn_split_plain(x, wg, wu, wd, token_mask, *, block: int = 128,
                        splits: int = 1, rows: int = TC_ROWS):
    """The tensor-core path's decomposition in plain PyTorch: h as in
    `dsg_ffn_plain` (rounded to x's dtype); for each 64-row tile the live
    128-column chunks of F of the `rows`-row cells that hold it, in
    ascending order, cut into `splits` contiguous runs, each run's f32
    partial of h @ wd, the partials summed in run order and rounded
    once."""
    m = x.shape[0]
    xf = x.float()
    h = F.silu(xf @ wg.float()) * (xf @ wu.float())
    h = (h.reshape(m, -1, block) * token_mask.float()[..., None]).reshape(
        m, -1).to(x.dtype).float()
    live = live_cells(token_mask, block, rows, TC_COLS)
    out = torch.zeros((m, wd.shape[1]), dtype=torch.float32,
                      device=x.device)
    for t in range(-(-m // TC_ROWS)):
        rs = slice(t * TC_ROWS, (t + 1) * TC_ROWS)
        chunks = torch.nonzero(live[t * TC_ROWS // rows]).flatten().tolist()
        per = -(-len(chunks) // splits)
        acc = 0.0
        for c0 in range(0, len(chunks), max(1, per)):
            cols = torch.cat([torch.arange(c * TC_COLS, (c + 1) * TC_COLS)
                              for c in chunks[c0:c0 + per]])
            acc = acc + h[rs][:, cols] @ wd[cols].float()
        out[rs] = acc
    return out.to(x.dtype)


def dsg_ffn(x, wg, wu, wd, token_mask, *, block: int = 128, bm: int = 128,
            bf: int = 128):
    """Launch the CUDA kernels that `tile_plan` picks (CUDA tensors only;
    raises otherwise).  The kernels skip dead cells of their own tiling;
    bm/bf are checked against the reference's contract and change nothing
    else.  The tensor-core path raises unless x, wg, wu and wd start on
    16-byte boundaries.  `launches` counts every call; `launches_tc` and
    `launches_simt` those of each path."""
    name = "dsg_ffn"
    m, d = x.shape
    f = wg.shape[1]
    check_tiles(m, f, block, bm, bf)
    dev = cuda_lib.require_cuda(name, x, wg, wu, wd, token_mask)
    code = cuda_lib.dtype_code(name, x, wg, wu, wd)
    cuda_lib.require_contiguous(name, x=x, wg=wg, wu=wu, wd=wd)
    if (wg.shape != (d, f) or wu.shape != (d, f) or wd.shape != (f, d)
            or token_mask.shape != (m, f // block)):
        raise ValueError(f"{name}: inconsistent shapes x {tuple(x.shape)}, "
                         f"wg {tuple(wg.shape)}, wd {tuple(wd.shape)}, "
                         f"token_mask {tuple(token_mask.shape)}, block "
                         f"{block}")
    p = tile_plan(m, d, f, block, x.dtype)
    if p.path == "tc":
        cuda_lib.require_aligned16(name, x=x, wg=wg, wu=wu, wd=wd)
    mask = token_mask.to(torch.float32).contiguous()
    live = torch.empty((-(-m // p.cell_rows), -(-f // p.cell_cols)),
                       dtype=torch.int32, device=dev)
    h = torch.empty((m, f), dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        if p.path == "tc":
            cuda_lib.launch(
                "repro_dsg_ffn_tile_tc", x.data_ptr(), wg.data_ptr(),
                wu.data_ptr(), wd.data_ptr(), mask.data_ptr(),
                live.data_ptr(), h.data_ptr(), out.data_ptr(), m, d, f,
                block, p.rows, p.splits, cuda_lib.stream(dev))
            dsg_ffn.launches_tc += 1
        else:
            cuda_lib.launch(
                "repro_dsg_ffn_tile", code, x.data_ptr(), wg.data_ptr(),
                wu.data_ptr(), wd.data_ptr(), mask.data_ptr(),
                live.data_ptr(), h.data_ptr(), out.data_ptr(), m, d, f,
                block, cuda_lib.stream(dev))
            dsg_ffn.launches_simt += 1
    dsg_ffn.launches += 1
    return out


dsg_ffn.launches = 0
dsg_ffn.launches_tc = 0
dsg_ffn.launches_simt = 0
