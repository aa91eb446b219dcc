"""Public entry points to the kernels, under the reference's `ops` names.

The device of the operands decides: CPU tensors run the kernel's plain
PyTorch version; CUDA tensors launch the hand-written kernel, which raises
for anything it does not take.  There is no switch and no fallback.
"""
from __future__ import annotations

from repro_torch.kernels import drs_search, dsg_ffn, paged_attention


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


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
