"""Mask algebra for DSG: {0,1} masks at neuron-group granularity (..., G)
that multiply the matching (..., G*block) activations.  Masks are data, not
functions of the parameters, so they are detached at creation."""
from __future__ import annotations

import torch


def freeze(mask: torch.Tensor) -> torch.Tensor:
    return mask.detach()


def apply_expanded(x: torch.Tensor, group_mask: torch.Tensor,
                   block: int) -> torch.Tensor:
    """x (..., G*block) * expand(group_mask (..., G))."""
    g = group_mask.shape[-1]
    xs = x.reshape(x.shape[:-1] + (g, block))
    return (xs * group_mask[..., None].to(x.dtype)).reshape(x.shape)
