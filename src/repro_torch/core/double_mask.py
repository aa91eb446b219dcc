"""Double-mask selection (the paper's §2.3): norm compatibility.

A normalisation layer turns the exact zeros DRS created into small
non-zeros.  The paper's fix applies the same selection mask again after
the norm, which is correct because the norm's per-channel scale and shift
keep the masked-out neurons removable.  `single_mask` is the ablation
that masks only before the norm.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import masks


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, axis: int = 0,
                     eps: float = 1e-5) -> torch.Tensor:
    """Training-mode BN over `axis` (per-feature batch statistics, the
    biased variance)."""
    mean = x.mean(dim=axis, keepdim=True)
    var = x.var(dim=axis, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def double_mask(norm_fn: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor, group_mask: torch.Tensor,
                block: int) -> torch.Tensor:
    """y = Mask(norm(Mask(x))): the (..., G) group mask applied before and
    after the norm, so the dataflow stays sparse."""
    m = masks.freeze(group_mask)
    return masks.apply_expanded(norm_fn(masks.apply_expanded(x, m, block)),
                                m, block)


def single_mask(norm_fn: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor, group_mask: torch.Tensor,
                block: int) -> torch.Tensor:
    """Mask only before the norm: the norm's output is dense again."""
    return norm_fn(masks.apply_expanded(x, masks.freeze(group_mask), block))
