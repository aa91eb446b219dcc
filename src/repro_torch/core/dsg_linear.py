"""DSG-sparsified SwiGLU FFN (the port of `repro.core.dsg_linear`).

Weights keep the reference layout: w_gate/w_up (d, F), w_down (F, d); the
DSG group dim is F split into G = F/block groups.  Paths:

  * `swiglu_dense`      — no DSG.
  * `swiglu_dsg_mask`   — paper-faithful per-token mask: DRS selects groups
                          online, the full products run, the mask zeroes the
                          dropped groups (prefill, and decode without the
                          serving runtime).
  * `swiglu_csr_masked` — the masked-dense reference for per-lane
                          group-CSR patterns.
  * `swiglu_csr`        — serving decode over per-lane group-CSR patterns
                          through the group-CSR kernel (`kernels/dsg_ffn.py`),
                          which reads only the listed groups' weight blocks.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import drs, masks, projection, sparse_mask


class DSGConfig(NamedTuple):
    enabled: bool = False
    gamma: float = 0.5            # fraction of neuron groups dropped
    eps: float = 0.5              # JLL epsilon -> projection dim k
    block: int = 128              # neuron-group width
    threshold_mode: str = "topk"  # "topk" | "shared"
    score: str = "relu_sum"
    mode: str = "mask"            # only "mask" is ported
    n_chunks: int = 1
    refresh_every: int = 50

    def drs_cfg(self) -> drs.DRSConfig:
        return drs.DRSConfig(gamma=self.gamma, block=self.block,
                             threshold_mode=self.threshold_mode,
                             score=self.score)


def proj_dim(d: int, n_out: int, cfg: DSGConfig) -> int:
    return projection.jll_dim(d, n_points=n_out + 1, eps=cfg.eps)


class SwiGLU(nn.Module):
    """SwiGLU FFN weights: w_gate/w_up (d, F), w_down (F, d)."""

    def __init__(self, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor):
        super().__init__()
        self.w_gate = nn.Parameter(w_gate, requires_grad=False)
        self.w_up = nn.Parameter(w_up, requires_grad=False)
        self.w_down = nn.Parameter(w_down, requires_grad=False)


def init_swiglu(d: int, f: int, *, generator: torch.Generator,
                dtype: torch.dtype, device=None) -> SwiGLU:
    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)
    return SwiGLU(normal((d, f), 1.0 / math.sqrt(d)),
                  normal((d, f), 1.0 / math.sqrt(d)),
                  normal((f, d), 1.0 / math.sqrt(f)))


def drs_group_mask(x: torch.Tensor, state: dict,
                   cfg: DSGConfig) -> torch.Tensor:
    """Per-token group mask (..., G) from the dimension-reduction search."""
    fx = projection.project_rows(state["r"], x)
    return masks.freeze(drs.drs_mask(fx, state["fw"], cfg.drs_cfg()))


def _gate_up(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return F.silu(x @ p.w_gate) * (x @ p.w_up)


def swiglu_dense(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return _gate_up(p, x) @ p.w_down


def swiglu_dsg_mask(p: SwiGLU, x: torch.Tensor, state: dict,
                    cfg: DSGConfig) -> torch.Tensor:
    """Paper-faithful per-token masked SwiGLU: dropped groups are zeroed
    after the nonlinearity."""
    mask = drs_group_mask(x, state, cfg)
    h = masks.apply_expanded(_gate_up(p, x), mask, cfg.block)
    return h @ p.w_down


def swiglu_ffn(p: SwiGLU, x: torch.Tensor, state: Optional[dict],
               cfg: DSGConfig) -> torch.Tensor:
    if not cfg.enabled or state is None:
        return swiglu_dense(p, x)
    if cfg.mode != "mask":
        raise ValueError(f"DSG mode {cfg.mode!r} is not ported (mask only; "
                         f"see ROADMAP.md)")
    return swiglu_dsg_mask(p, x, state, cfg)


def swiglu_csr_masked(p: SwiGLU, x: torch.Tensor, idx: torch.Tensor,
                      counts: torch.Tensor, *, block: int) -> torch.Tensor:
    """Masked-dense reference for a per-lane CSR selection: expand the
    index list to a dense group mask and run the full products.
    x (B, S, d), idx (B, K), counts (B,)."""
    mask = sparse_mask.csr_to_dense(idx, counts, p.w_gate.shape[1] // block)
    h = masks.apply_expanded(_gate_up(p, x), masks.freeze(mask[:, None, :]),
                             block)
    return h @ p.w_down


def swiglu_csr(p: SwiGLU, x: torch.Tensor, idx: torch.Tensor,
               counts: torch.Tensor, *, block: int,
               apply: str = "auto") -> torch.Tensor:
    """Group-CSR SwiGLU decode step.  Both modes run `ops.dsg_ffn_csr`,
    where the device decides: "auto" takes the kernel for CUDA tensors and
    its plain version for CPU tensors; "kernel" raises for a tensor that
    is not on CUDA."""
    if apply not in ("auto", "kernel"):
        raise ValueError(f"unknown CSR FFN apply mode {apply!r} (the port "
                         f"has 'auto' and 'kernel')")
    if x.shape[1] != 1:
        raise ValueError(
            f"CSR FFN kernel is a decode step (one token per lane), got "
            f"S={x.shape[1]}; use swiglu_csr_masked for multi-token rows")
    if apply == "kernel" and x.device.type != "cuda":
        raise RuntimeError(f"apply='kernel' needs CUDA tensors, got a "
                           f"{x.device.type} tensor")
    from repro_torch.kernels import ops
    y = ops.dsg_ffn_csr(x[:, 0], p.w_gate, p.w_up, p.w_down, idx, counts,
                        block=block)
    return y[:, None, :]
