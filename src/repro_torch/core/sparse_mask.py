"""Group-CSR masks — the serving-side selection representation.

A CSR row is (idx, count): `idx[:count]` lists the active group indices in
ascending order; entries past `count` are padding that every consumer
ignores.  The row width is a static bound bucketed to a power of two, so
per-lane counts drifting between steps reuse a few shapes.
"""
from __future__ import annotations

import torch


def active_group_bound(max_count: int, n_groups: int) -> int:
    """CSR row width covering rows with up to `max_count` active groups:
    the count rounded up to a power of two, capped at G."""
    need = max(1, int(max_count))
    return min(1 << (need - 1).bit_length(), n_groups)


def active_group_buckets(n_groups: int) -> tuple:
    """Every bound active_group_bound can return for G groups."""
    return tuple(sorted({min(1 << i, n_groups)
                         for i in range(n_groups.bit_length() + 1)}))


def csr_to_dense(idx: torch.Tensor, counts: torch.Tensor,
                 n_groups: int) -> torch.Tensor:
    """(idx (..., K), counts (...,)) -> dense {0,1} float32 mask (..., G).
    Padded entries (positions >= count) are ignored, whatever they hold."""
    k = idx.shape[-1]
    # a listed index outside [0, G) adds nothing, as the reference's
    # one-hot gives it no column
    valid = ((torch.arange(k, device=idx.device) < counts[..., None])
             & (idx >= 0) & (idx < n_groups))
    dense = torch.zeros(idx.shape[:-1] + (n_groups,), dtype=torch.float32,
                        device=idx.device)
    dense.scatter_add_(-1, torch.where(valid, idx, 0).long(),
                       valid.to(torch.float32))
    return dense.clamp_(max=1.0)


def dense_to_csr(mask: torch.Tensor, bound: int):
    """Dense group mask (..., G) -> (idx (..., bound) int32, counts (...,)
    int32).  Sorting the key `where(active, g, G + g)` lists the active
    groups first, each side ascending, so the leading `bound` entries are
    the active list when `bound` covers the row's count (longer rows are
    truncated).  Padding is zeroed, so a row's form is canonical."""
    g = mask.shape[-1]
    active = mask > 0
    ar = torch.arange(g, device=mask.device)
    key = torch.where(active, ar, g + ar)
    order = torch.argsort(key, dim=-1)[..., :bound].to(torch.int32)
    counts = active.sum(dim=-1).clamp(max=bound).to(torch.int32)
    valid = torch.arange(bound, device=mask.device) < counts[..., None]
    return torch.where(valid, order, 0), counts


def csr_rows(shape: tuple) -> int:
    rows = 1
    for s in shape:
        rows *= s
    return rows


def csr_overhead_bytes(batch_shape: tuple, bound: int, idx_bytes: int = 4,
                       count_bytes: int = 4) -> int:
    """Storage cost of the CSR pattern state: `bound` int32 indices and one
    int32 count per row (compare `masks.mask_overhead_bytes`, one bit per
    group per row)."""
    return csr_rows(batch_shape) * (bound * idx_bytes + count_bytes)
