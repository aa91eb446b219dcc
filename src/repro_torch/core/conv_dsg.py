"""Paper-native CONV path: DSG on convolutions via im2col (the paper's
§2.2), the port of `repro.core.conv_dsg`.

Each CONV layer in VMM form: every output position is a sliding-window
row X_i (n_CRS = C*R*S) against the filter matrix (n_CRS, n_K); DRS
estimates the n_K output activations per window and masks the
non-critical filters per position.  Includes the double-mask BN hookup:
CONV -> ReLU(masked) -> BN -> the same mask (the paper's Fig. 2(c), with
its CONV-ReLU-BN reordering).  No model calls it; the paper-fidelity
tests do.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import double_mask as dm
from repro_torch.core import drs, masks, projection
from repro_torch.core.dsg_linear import DSGConfig


def _same_pad(r: int) -> Tuple[int, int]:
    """The reference's SAME padding of a window of r: (r // 2, (r-1) // 2)
    before and after."""
    return r // 2, (r - 1) // 2


def im2col(x: torch.Tensor, rs: Tuple[int, int],
           padding: str = "SAME") -> torch.Tensor:
    """x (B, H, W, C) -> patches (B, H', W', R*S*C), each row ordered (R,
    S, C) as the reference's."""
    r, s = rs
    (ph0, ph1), (pw0, pw1) = ((_same_pad(r), _same_pad(s))
                              if padding == "SAME" else ((0, 0), (0, 0)))
    xp = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
    b, hp, wp, c = xp.shape
    ho, wo = hp - r + 1, wp - s + 1
    patches = xp.unfold(1, r, 1).unfold(2, s, 1)      # (B, H', W', C, R, S)
    return patches.permute(0, 1, 2, 4, 5, 3).reshape(b, ho, wo, r * s * c)


def init_conv_dsg(c_in: int, rs: Tuple[int, int], n_k: int, cfg: DSGConfig,
                  *, generator: torch.Generator, device=None) -> dict:
    """Filter matrix w (CRS, K) + DSG state: R (k, CRS) and f(W) = R w."""
    crs = rs[0] * rs[1] * c_in
    w = torch.randn((crs, n_k), generator=generator,
                    device=device) / math.sqrt(crs)
    r = projection.make_projection(projection.jll_dim(crs, n_k, cfg.eps),
                                   crs, generator=generator, device=device)
    return {"w": w, "r": r, "fw": projection.project(r, w)}


def conv2d_dsg(p: dict, x: torch.Tensor, rs: Tuple[int, int],
               cfg: DSGConfig, bn_scale: Optional[torch.Tensor] = None,
               bn_bias: Optional[torch.Tensor] = None,
               mask_mode: str = "double"):
    """DSG convolution: im2col -> DRS per sliding window -> masked VMM ->
    ReLU -> (optional BN with the double or single mask).

    x (B, H, W, C) -> (y (B, H', W', K), group mask (B*H'*W', G) or
    None)."""
    patches = im2col(x, rs)
    b, ho, wo, crs = patches.shape
    rows = patches.reshape(-1, crs)
    gmask = None
    if cfg.enabled:
        fx = projection.project_rows(p["r"], rows)
        gmask = masks.freeze(drs.drs_mask(fx, p["fw"], cfg.drs_cfg()))
    act = torch.relu(rows @ p["w"])
    if gmask is not None:
        act = masks.apply_expanded(act, gmask, cfg.block)
    if bn_scale is not None:
        def bn(z):
            return dm.batch_norm_train(z, bn_scale, bn_bias)
        if gmask is None:
            act = bn(act)
        elif mask_mode == "double":
            act = dm.double_mask(bn, act, gmask, cfg.block)
        else:
            act = dm.single_mask(bn, act, gmask, cfg.block)
    return act.reshape(b, ho, wo, -1), gmask


def conv2d_ref(w: torch.Tensor, x: torch.Tensor,
               rs: Tuple[int, int]) -> torch.Tensor:
    """F.conv2d oracle for the unmasked path: w (R*S*C, K) as an HWIO
    kernel, x NHWC, padded as lax's "SAME" pads (the extra row or column
    after, for an even window)."""
    r, s = rs
    c_in, n_k = x.shape[-1], w.shape[-1]
    kernel = w.reshape(r, s, c_in, n_k).permute(3, 2, 0, 1)     # OIHW
    (ph0, ph1), (pw0, pw1) = ((r - 1) // 2, r // 2), ((s - 1) // 2, s // 2)
    xp = F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    return F.conv2d(xp, kernel).permute(0, 2, 3, 1)
