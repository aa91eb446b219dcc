"""Shared layer primitives: RMS norm, split-half RoPE, init helpers."""
from __future__ import annotations

import math

import torch
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in f32, returned in x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = nn.Parameter(scale, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale)


def norm_init(d: int, *, dtype: torch.dtype, device=None) -> RMSNorm:
    return RMSNorm(torch.ones(d, dtype=dtype, device=device))


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half RoPE in f32.  x (..., S, H, D), positions broadcastable
    to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_init(shape, fan_in: int, *, generator: torch.Generator,
               dtype: torch.dtype, device=None) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, device=device)
            / math.sqrt(fan_in)).to(dtype)


def embed_init(vocab: int, d: int, *, generator: torch.Generator,
               dtype: torch.dtype, device=None) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=generator, device=device)
            * 0.02).to(dtype)
