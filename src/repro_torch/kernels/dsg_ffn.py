"""Group-CSR SwiGLU decode: the CUDA kernel `csrc/dsg_ffn.cu` (replacing the
Pallas `repro/kernels/dsg_ffn.py::dsg_ffn_csr`) and its plain PyTorch
version.

x (B, d) holds one token per lane, wg/wu (d, F), wd (F, d), idx (B, K) the
lane's active group indices (ascending, padded past counts), counts (B,)
-> (B, d) in x's dtype.  Only the listed groups' weight blocks are read.

h = silu(x . wg[:, blk]) * (x . wu[:, blk]) is rounded to x's dtype before
the down projection, as in the reference; the down projection then
accumulates in f32 and rounds once, where the Pallas kernel rounds its
accumulator to x's dtype after every slot.  In f32 the two agree to
summation order; in bf16 the port's output is the more accurate one and
differs from the reference by up to about one bf16 ulp per slot added.

Bound on the H100: bytes (see the source note in the .cu file).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_lib

GATE_UP_THREADS = 512   # kGateUpThreads in dsg_ffn.cu; block must divide it
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
