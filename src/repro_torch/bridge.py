"""Carry the JAX package's parameters and DSG state into the port.

The reference builds its weights with JAX's PRNG, which torch cannot
replay, so a parity test builds them there, converts every leaf to numpy
(`jax.tree.map(np.asarray, params)`) and hands the nested dicts here.  The
reference stacks per-layer leaves (L, ...) for lax.scan; the port keeps
one module per layer, so the stacks are split along their first axis.  The
DSG state keeps its stacked fw (L, k, F) in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsg_linear import DSGConfig, SwiGLU
from repro_torch.models.attention import Attention
from repro_torch.models.layers import RMSNorm
from repro_torch.models.transformer import Block, Transformer


def tensor(a, device=None) -> torch.Tensor:
    """numpy array (bfloat16 from ml_dtypes included) -> torch tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def model_from_jax(params: dict, cfg, device=None) -> Transformer:
    """A `repro.models.transformer.init_model` pytree -> Transformer."""
    lay = params["layers"]

    def take(leaf, l):
        return tensor(np.asarray(leaf)[l], device)

    layers = []
    for l in range(cfg.n_layers):
        a, f = lay["attn"], lay["ffn"]
        layers.append(Block(
            RMSNorm(take(lay["ln_attn"]["scale"], l)),
            Attention(take(a["wq"], l), take(a["wk"], l), take(a["wv"], l),
                      take(a["wo"], l)),
            RMSNorm(take(lay["ln_ffn"]["scale"], l)),
            SwiGLU(take(f["w_gate"], l), take(f["w_up"], l),
                   take(f["w_down"], l))))
    lm_head = params.get("lm_head")
    return Transformer(tensor(params["embed"], device), layers,
                       RMSNorm(tensor(params["ln_final"]["scale"], device)),
                       tensor(lm_head, device) if lm_head is not None
                       else None)


def config_from_jax(ref_cfg) -> ModelConfig:
    """A `repro.configs.base.ModelConfig` (read field by field) -> the
    port's ModelConfig with the same values."""
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    kw["dsg"] = DSGConfig(*ref_cfg.dsg)
    return ModelConfig(**kw)


def dsg_from_jax(dsg: Optional[dict], device=None) -> Optional[dict]:
    """A `repro.models.transformer.init_dsg` state -> {'r', 'fw'}."""
    if dsg is None:
        return None
    return {"r": tensor(dsg["r"], device), "fw": tensor(dsg["fw"], device)}
