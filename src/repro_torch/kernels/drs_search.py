"""DRS search: the CUDA kernels `csrc/drs_search.cu` (replacing the Pallas
`repro/kernels/drs_search.py::drs_project` and `::drs_scores`) and their
plain PyTorch versions.

drs_project: f(X) = X @ R^T, x (M, d), r (k, d) -> (M, k) in x's dtype
with f32 accumulation.  Unlike the Pallas kernel, any M is taken.
drs_scores: relu(fx @ fw) summed over each `block`-wide group,
fx (M, k), fw (k, F) -> (M, F / block) f32, in one pass.

Bound on the H100: bytes for both (see the source note in the .cu file).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib

MAX_ROWS = 16          # kMaxRows in drs_search.cu
SMEM_LIMIT = 48 * 1024


def drs_project_plain(x, r):
    return (x.float() @ r.float().t()).to(x.dtype)


def drs_scores_plain(fx, fw, *, block: int = 128):
    v = fx.float() @ fw.float()
    m, f = v.shape
    return torch.relu(v).reshape(m, f // block, block).sum(dim=-1)


def drs_project(x, r):
    """Launch the CUDA kernel (CUDA tensors only; raises otherwise)."""
    name = "drs_project"
    dev = cuda_lib.require_cuda(name, x, r)
    code = cuda_lib.dtype_code(name, x, r)
    cuda_lib.require_contiguous(name, x=x, r=r)
    m, d = x.shape
    k = r.shape[0]
    if r.shape != (k, d):
        raise ValueError(f"{name}: x {tuple(x.shape)} and r "
                         f"{tuple(r.shape)} disagree on d")
    out = torch.empty((m, k), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        cuda_lib.launch("repro_drs_project", code, x.data_ptr(), r.data_ptr(),
                        out.data_ptr(), m, k, d, cuda_lib.stream(dev))
    drs_project.launches += 1
    return out


drs_project.launches = 0


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
