"""Mask algebra for DSG: {0,1} masks at neuron-group granularity (..., G)
that multiply the matching (..., G*block) activations.  Masks are data, not
functions of the parameters, so they are detached at creation."""
from __future__ import annotations

import torch

from repro_torch.parallel.context import whole_group_grads, whole_groups


def freeze(mask: torch.Tensor) -> torch.Tensor:
    return mask.detach()


def apply_expanded(x: torch.Tensor, group_mask: torch.Tensor,
                   block: int) -> torch.Tensor:
    """x (..., G*block) * expand(group_mask (..., G))."""
    g = group_mask.shape[-1]
    x, group_mask = whole_groups(x, block), whole_groups(group_mask, 1)
    xs = x.reshape(x.shape[:-1] + (g, block))
    return whole_group_grads(
        (xs * group_mask[..., None].to(x.dtype)).reshape(x.shape), block)


def density(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of ones."""
    return mask.to(torch.float32).mean()


def mask_overhead_bytes(shape: tuple, block: int) -> int:
    """Bitmask storage cost for the stash (the paper puts it under 2% of
    memory): one bit per neuron group per row, byte-rounded."""
    rows = 1
    for s in shape[:-1]:
        rows *= s
    groups = shape[-1] // block
    return rows * ((groups + 7) // 8)
