"""Flash attention: the CUDA kernel `csrc/flash_attention.cu` (replacing the
Pallas `repro/kernels/flash_attention.py::flash_attention`) and its plain
PyTorch version.

q (BH, S, D), k/v (BH, T, D) -> (BH, S, D) in q's dtype; heads are folded
into the leading dim by the caller (GQA callers repeat kv heads first).
q, k and v are upcast to f32, scores are (q . k) / sqrt(D), and the
output is rounded once to q's dtype.  Under `causal`, query row i sits at
absolute position i + (T - S) and sees keys j <= i + (T - S).

A row that sees no key (causal with S > T, rows i < S - T) gives zeros,
as the Pallas kernel does: its probabilities are masked after exp and the
sum is floored at 1e-20.  `ref.flash_attention_ref` of the reference
package gives the mean of v there instead, since it takes a softmax over
a row of -1e30.

Bound on the H100: bytes (see the source note in the .cu file).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda_lib

NEG = -1e30
MAX_D = 256            # kMaxD in flash_attention.cu


def check_blocks(s_len: int, t_len: int, block_q: int, block_k: int) -> None:
    """The reference's tiling contract: block_q = min(block_q, S) divides S
    and block_k = min(block_k, T) divides T."""
    block_q, block_k = min(block_q, s_len), min(block_k, t_len)
    if block_q < 1 or block_k < 1 or s_len % block_q or t_len % block_k:
        raise ValueError(f"flash_attention: S={s_len}, T={t_len} do not "
                         f"split into blocks of {block_q} and {block_k}")


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Plain PyTorch version: masked softmax in f32, the masked
    probabilities zeroed after exp, acc / max(l, 1e-20)."""
    s_len, t_len = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (
        1.0 / math.sqrt(q.shape[-1]))
    if causal:
        mask = torch.ones((s_len, t_len), dtype=torch.bool,
                          device=q.device).tril(t_len - s_len)
        s = torch.where(mask, s, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if causal:
        p = torch.where(mask, p, 0.0)
    o = torch.einsum("bqk,bkd->bqd", p, v.float())
    return (o / p.sum(dim=-1, keepdim=True).clamp_min(1e-20)).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """Launch the CUDA kernel (CUDA tensors only; raises otherwise).  The
    kernel picks its own tiles; block_q/block_k are checked against the
    reference's contract and change nothing else."""
    name = "flash_attention"
    bh, s_len, d = q.shape
    t_len = k.shape[1]
    check_blocks(s_len, t_len, block_q, block_k)
    dev = cuda_lib.require_cuda(name, q, k, v)
    code = cuda_lib.dtype_code(name, q, k, v)
    cuda_lib.require_contiguous(name, q=q, k=k, v=v)
    if k.shape != (bh, t_len, d) or v.shape != (bh, t_len, d):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} disagree")
    if d > MAX_D:
        raise ValueError(f"{name}: head dim {d} is above the kernel's "
                         f"{MAX_D}")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        cuda_lib.launch("repro_flash_attention", code, q.data_ptr(),
                        k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
                        s_len, t_len, d, int(causal),
                        t_len - s_len if causal else 0, 1.0 / math.sqrt(d),
                        cuda_lib.stream(dev))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
