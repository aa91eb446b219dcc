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
    valid = (torch.arange(k, device=idx.device)
             < counts[..., None]).to(torch.float32)
    dense = torch.zeros(idx.shape[:-1] + (n_groups,), dtype=torch.float32,
                        device=idx.device)
    dense.scatter_add_(-1, idx.long(), valid)
    return dense.clamp_(max=1.0)
