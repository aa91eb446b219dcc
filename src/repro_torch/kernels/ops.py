"""Public entry points to the kernels, under the reference's `ops` names.

The device of the operands decides: CPU tensors run the kernel's plain
PyTorch version (so do meta tensors, which hold shapes only: the dry
run); CUDA tensors launch the hand-written kernel, which raises for
anything it does not take.  There is no switch and no fallback.
"""
from __future__ import annotations

from repro_torch.core import drs
from repro_torch.kernels import (drs_search, dsg_ffn, flash_attention as fa,
                                 paged_attention)


def _on_cpu(t) -> bool:
    return t.device.type in ("cpu", "meta")


def drs_project(x, r):
    """f(X) = X @ R^T: x (M, d), r (k, d) -> (M, k)."""
    if _on_cpu(x):
        return drs_search.drs_project_plain(x, r)
    return drs_search.drs_project(x, r)


def drs_scores(fx, fw, block: int = 128):
    """Fused virtual products + relu-sum group scores: fx (M, k),
    fw (k, F) -> (M, F / block) f32."""
    if _on_cpu(fx):
        return drs_search.drs_scores_plain(fx, fw, block=block)
    return drs_search.drs_scores(fx, fw, block=block)


def dsg_ffn_csr(x, wg, wu, wd, idx, counts, block: int = 128):
    """Group-CSR SwiGLU decode step: x (B, d), idx (B, K), counts (B,)
    -> (B, d)."""
    if _on_cpu(x):
        return dsg_ffn.dsg_ffn_csr_plain(x, wg, wu, wd, idx, counts,
                                         block=block)
    return dsg_ffn.dsg_ffn_csr(x, wg, wu, wd, idx, counts, block=block)


def dsg_ffn_fwd(x, wg, wu, wd, token_mask, block: int = 128, bm: int = 128,
                bf: int = 128):
    """Tile-masked SwiGLU FFN over multi-token rows: x (M, d),
    token_mask (M, F / block) {0,1} -> (M, d).  bm/bf are the reference's
    (token tile, hidden block) cells, checked on either device."""
    if _on_cpu(x):
        dsg_ffn.check_tiles(x.shape[0], wg.shape[1], block, bm, bf)
        return dsg_ffn.dsg_ffn_plain(x, wg, wu, wd, token_mask, block=block)
    return dsg_ffn.dsg_ffn(x, wg, wu, wd, token_mask, block=block, bm=bm,
                           bf=bf)


def dsg_ffn_full(x, wg, wu, wd, r, fw, gamma: float, block: int = 128):
    """End-to-end DSG FFN through the kernels: project -> scores -> per-row
    top-k group mask -> tile-masked FFN.  x (M, d), r (k, d), fw (k, F)
    -> (M, d)."""
    fx = drs_project(x, r)
    scores = drs_scores(fx, fw, block=block)
    cfg = drs.DRSConfig(gamma=gamma, block=block, threshold_mode="topk")
    mask = drs.select_mask(scores, fw.shape[1], cfg)
    return dsg_ffn_fwd(x, wg, wu, wd, mask, block=block)


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """Online-softmax attention: q (BH, S, D), k/v (BH, T, D) -> (BH, S, D);
    under `causal`, query row i sits at position i + T - S.  block_q and
    block_k are the reference's tiles, checked on either device."""
    if _on_cpu(q):
        fa.check_blocks(q.shape[1], k.shape[1], block_q, block_k)
        return fa.flash_attention_plain(q, k, v, causal=causal)
    return fa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                              block_k=block_k)


def paged_decode_attention(q, k_new, v_new, k_pages, v_pages, page_table,
                           pos, window: int = 0, num_pages: int = 0):
    """Fused paged decode step; the pools are updated in place.
    q (B, H, D), k_new/v_new (B, Kv, D), pools (P, ps, Kv, D),
    page_table (B, max_pages), pos (B,) -> (o, k_pages, v_pages)."""
    if _on_cpu(q):
        return paged_attention.paged_decode_plain(
            q, k_new, v_new, k_pages, v_pages, page_table, pos,
            window=window, num_pages=num_pages)
    return paged_attention.paged_decode(
        q, k_new, v_new, k_pages, v_pages, page_table, pos, window=window,
        num_pages=num_pages)
