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

Two kernels, picked by `plan` from dtype and shape (never on failure):
bf16 with D a multiple of 64 takes the tensor-core kernel (wgmma and TMA,
P rounded to bf16 before the PV product), with the keys split across
blocks where the query tiles are fewer than the SMs and the splits merged
in order; f32, and other D, take the SIMT kernel.  `flash_split_plain`
is the split decomposition in plain PyTorch.

Bound on the H100: bytes (see the source note in the .cu file).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import cuda_lib

NEG = -1e30
MAX_D = 256            # kMaxD in flash_attention.cu
SM_COUNT = 132         # H100 SXM
SM_SMEM = 233472       # shared memory of one H100 SM, bytes
TC_ROWS = 64           # query rows per tensor-core block (the wgmma M)
TC_KEYS = 64           # keys per tensor-core tile
TC_STAGES = 2          # K/V ring depth (kTcStages)
SIMT_ROWS = 32         # kBQ in flash_attention.cu


class Plan(NamedTuple):
    path: str              # "tc" or "simt"
    splits: int            # key splits (tc; 1 = no merge launch)
    tiles_per_split: int   # TC_KEYS-key tiles per split (tc)
    blocks: int            # blocks of the main launch


def tc_blocks_per_sm(d: int) -> int:
    """Tensor-core blocks that fit on one SM at once by shared memory (Q
    and the K/V ring of 64 x 64 bf16 tiles, plus 1 KB for alignment and 1 KB
    the SM reserves per block), at most 4."""
    smem = (d // 64) * TC_ROWS * 64 * 2 * (1 + 2 * TC_STAGES) + 2048
    return max(1, min(4, SM_SMEM // smem))


def plan(bh: int, s_len: int, t_len: int, d: int, dtype) -> Plan:
    """The kernel and split-KV layout for these shapes.  Where the query
    tiles are fewer than the SMs, the key tiles are split into runs of at
    least two, into as many splits as keep the blocks within what the SMs
    hold at once (measured best on the H100 at the main shapes: PERF.md)."""
    if dtype != torch.bfloat16 or d % 64 or d > MAX_D:
        return Plan("simt", 1, 0, bh * -(-s_len // SIMT_ROWS))
    q_tiles = bh * -(-s_len // TC_ROWS)
    n_kt = -(-t_len // TC_KEYS)
    want = (1 if q_tiles >= SM_COUNT
            else max(1, SM_COUNT * tc_blocks_per_sm(d) // q_tiles))
    per = max(2, -(-n_kt // min(want, n_kt)))
    splits = -(-n_kt // per)
    return Plan("tc", splits, per, q_tiles * splits)


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


def flash_split_plain(q, k, v, *, causal: bool = True,
                      tiles_per_split: int, block_k: int = TC_KEYS):
    """The tensor-core kernel's split-KV decomposition in plain PyTorch, in
    f32: the key tiles of `block_k` fall into runs of `tiles_per_split`;
    each run keeps its own online softmax (m, l, acc), where a row that
    sees no key in the run keeps m = NEG, l = 0, acc = 0; the runs merge in
    order.  Returns q's dtype."""
    bh, s_len, d = q.shape
    t_len = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    row = torch.arange(s_len, device=q.device)[:, None] + (t_len - s_len)
    n_kt = -(-t_len // block_k)
    parts = []
    for t0 in range(0, n_kt, tiles_per_split):
        m = torch.full((bh, s_len, 1), NEG, device=q.device)
        l = torch.zeros((bh, s_len, 1), device=q.device)
        acc = torch.zeros((bh, s_len, d), device=q.device)
        for kt in range(t0, min(n_kt, t0 + tiles_per_split)):
            keys = slice(kt * block_k, min(t_len, (kt + 1) * block_k))
            s = torch.einsum("bqd,bkd->bqk", qf, kf[:, keys]) * scale
            seen = torch.ones_like(s[0], dtype=torch.bool)
            if causal:
                seen = torch.arange(keys.start, keys.stop,
                                    device=q.device)[None, :] <= row
            s = torch.where(seen, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(seen, torch.exp(s - m_new), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p @ vf[:, keys]
            m = m_new
        parts.append((m, l, acc))
    return flash_merge_plain(parts).to(q.dtype)


def flash_merge_plain(parts):
    """Merge split partials [(m, l, acc), ...] in order: with m the max of
    the m_s, acc = sum acc_s exp(m_s - m), l = sum l_s exp(m_s - m), and
    out = acc / max(l, 1e-20) in f32.  Rows no split saw stay 0."""
    m = parts[0][0]
    for mp, _, _ in parts[1:]:
        m = torch.maximum(m, mp)
    l, acc = 0.0, 0.0
    for mp, lp, ap in parts:
        w = torch.exp(mp - m)
        l = l + lp * w
        acc = acc + ap * w
    return acc / torch.clamp_min(l, 1e-20)


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """Launch the CUDA kernel that `plan` picks (CUDA tensors only; raises
    otherwise).  The kernels pick their own tiles; block_q/block_k are
    checked against the reference's contract and change nothing else.
    The tensor-core path raises unless q, k and v start on 16-byte
    boundaries.  `launches` counts every call; `launches_tc` and
    `launches_simt` those of each path."""
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
    p = plan(bh, s_len, t_len, d, q.dtype)
    if p.path == "tc":
        cuda_lib.require_aligned16(name, q=q, k=k, v=v)
    out = torch.empty_like(q)
    offset = t_len - s_len if causal else 0
    with torch.cuda.device(dev):
        if p.path == "tc":
            ws_acc = ws_ml = out                   # read only when split
            if p.splits > 1:
                ws_acc = torch.empty((p.splits, bh, s_len, d),
                                     dtype=torch.float32, device=dev)
                ws_ml = torch.empty((p.splits, bh, s_len, 2),
                                    dtype=torch.float32, device=dev)
            cuda_lib.launch("repro_flash_attention_tc", q.data_ptr(),
                            k.data_ptr(), v.data_ptr(), out.data_ptr(),
                            ws_acc.data_ptr(), ws_ml.data_ptr(), bh, s_len,
                            t_len, d, int(causal), offset,
                            1.0 / math.sqrt(d), p.tiles_per_split, p.splits,
                            cuda_lib.stream(dev))
            cuda_lib.count(flash_attention, "tc")
        else:
            cuda_lib.launch("repro_flash_attention", code, q.data_ptr(),
                            k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
                            s_len, t_len, d, int(causal), offset,
                            1.0 / math.sqrt(d), cuda_lib.stream(dev))
            cuda_lib.count(flash_attention, "simt")
    return out


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_simt = 0
