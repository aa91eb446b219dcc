"""Group-sparse SwiGLU FFN: the CUDA kernels of `csrc/dsg_ffn.cu` and their
plain PyTorch versions.

dsg_ffn_csr (replacing the Pallas `repro/kernels/dsg_ffn.py::dsg_ffn_csr`),
the group-CSR decode step: x (B, d) holds one token per lane, wg/wu
(d, F), wd (F, d), idx (B, K) the lane's active group indices (ascending,
padded past counts), counts (B,) -> (B, d) in x's dtype.  Only the listed
groups' weight blocks are read.

dsg_ffn (replacing the Pallas `repro/kernels/dsg_ffn.py::dsg_ffn`), the
tile-masked FFN over multi-token rows: x (M, d), token_mask (M, F / block)
{0, 1} -> (M, d) in x's dtype.  A (token tile x hidden block) cell that no
token of the tile selected is skipped; live cells re-apply the per-token
mask, so the output is the per-token masked FFN whatever cells are
skipped.  `tile_skip_fraction` counts the dead cells of the reference's
(bm, bf) tiling.

Both round h = silu(x . wg) * (x . wu) to x's dtype before the down
projection, as in the reference; the down projection then accumulates in
f32 and rounds once, where the Pallas kernels round their accumulator to
x's dtype after every slot or F block.  In f32 the two agree to summation
order; in bf16 the port's output is the more accurate one and differs from
the reference by up to about one bf16 ulp per slot or F block added.

Bound on the H100: bytes (see the source note in the .cu file).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_lib

GATE_UP_THREADS = 512   # kGateUpThreads in dsg_ffn.cu; block must divide it
TILE = 64               # kTM = kTN in dsg_ffn.cu: the tile kernel's cells
SMEM_LIMIT = 48 * 1024


def dsg_ffn_csr_plain(x, wg, wu, wd, idx, counts, *, block: int = 128):
    """Plain PyTorch version: gather each lane's listed column blocks,
    SwiGLU in f32, h rounded to x's dtype, zero the padded slots, down
    projection accumulated in f32."""
    b, d = x.shape
    k = idx.shape[1]
    cols = (idx.long()[..., None] * block
            + torch.arange(block, device=x.device)).reshape(b, k * block)
    xf = x.float()
    g = torch.einsum("bd,bdm->bm", xf, wg[:, cols].permute(1, 0, 2).float())
    u = torch.einsum("bd,bdm->bm", xf, wu[:, cols].permute(1, 0, 2).float())
    h = (F.silu(g) * u).to(x.dtype).float()
    valid = torch.arange(k, device=x.device) < counts[:, None]
    h = h * valid.repeat_interleave(block, dim=1)
    return torch.einsum("bm,bmd->bd", h, wd[cols].float()).to(x.dtype)


def dsg_ffn_csr(x, wg, wu, wd, idx, counts, *, block: int = 128):
    """Launch the CUDA kernel (CUDA tensors only; raises otherwise)."""
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
    if block > GATE_UP_THREADS or GATE_UP_THREADS % block:
        raise ValueError(f"{name}: block {block} must divide "
                         f"{GATE_UP_THREADS}")
    if 4 * (d + 2 * GATE_UP_THREADS) > SMEM_LIMIT:
        raise ValueError(f"{name}: d={d} needs more shared memory than "
                         f"{SMEM_LIMIT} bytes")
    h = torch.empty((b, k, block), dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        cuda_lib.launch(
            "repro_dsg_ffn_csr", code, x.data_ptr(), wg.data_ptr(),
            wu.data_ptr(), wd.data_ptr(), idx.data_ptr(), counts.data_ptr(),
            h.data_ptr(), out.data_ptr(), b, d, f, k, block,
            cuda_lib.stream(dev))
    dsg_ffn_csr.launches += 1
    return out


dsg_ffn_csr.launches = 0


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


def dsg_ffn_plain(x, wg, wu, wd, token_mask, *, block: int = 128):
    """Plain PyTorch version: the full SwiGLU in f32, the per-token group
    mask applied, h rounded to x's dtype, down projection in f32."""
    m = x.shape[0]
    xf = x.float()
    h = F.silu(xf @ wg.float()) * (xf @ wu.float())
    h = (h.reshape(m, -1, block) * token_mask.float()[..., None]).reshape(
        m, -1)
    return (h.to(x.dtype).float() @ wd.float()).to(x.dtype)


def dsg_ffn(x, wg, wu, wd, token_mask, *, block: int = 128, bm: int = 128,
            bf: int = 128):
    """Launch the CUDA kernel (CUDA tensors only; raises otherwise).  The
    kernel skips dead cells of its own tiling; bm/bf are checked against
    the reference's contract and change nothing else."""
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
    mask = token_mask.to(torch.float32).contiguous()
    live = torch.empty((-(-m // TILE), -(-f // TILE)), dtype=torch.int32,
                       device=dev)
    h = torch.empty((m, f), dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        cuda_lib.launch(
            "repro_dsg_ffn_tile", code, x.data_ptr(), wg.data_ptr(),
            wu.data_ptr(), wd.data_ptr(), mask.data_ptr(), live.data_ptr(),
            h.data_ptr(), out.data_ptr(), m, d, f, block,
            cuda_lib.stream(dev))
    dsg_ffn.launches += 1
    return out


dsg_ffn.launches = 0
