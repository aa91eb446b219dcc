"""Carry the JAX package's parameters and DSG state into the port.

The reference builds its weights with JAX's PRNG, which torch cannot
replay, so a parity test builds them there, converts every leaf to numpy
(`jax.tree.map(np.asarray, params)`) and hands the nested dicts here.  The
reference stacks per-layer leaves (L, ...) for lax.scan; the port keeps
one module per layer, so the stacks are split along their first axis.  The
DSG state keeps its stacked leaves (fw (L, k, F), or an MoE's fw_experts
(L, E, k, F_e) and fw_shared (L, k, n_shared · F_e)) in both packages.

The other way, `state_tree` lays the trainer's state (model, DSG state,
AdamW state, error feedback) out as the reference's tree: per-layer leaves
stacked over L under `layers`, the optimizer's `m`/`v`/`master` mirroring
`params`.  The checkpoint keys are its tree paths, and `state_to_numpy`
gives it as numpy arrays for the parity tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsg_linear import DSGConfig, SwiGLU
from repro_torch.models.api import require_device
from repro_torch.models.attention import Attention
from repro_torch.models.layers import RMSNorm
from repro_torch.models.moe import MoE
from repro_torch.models.transformer import Block, Transformer, set_trainable


def tensor(a, device=None) -> torch.Tensor:
    """numpy array (bfloat16 from ml_dtypes included) -> torch tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def model_from_jax(params: dict, cfg, device="cuda",
                   trainable: bool = False) -> Transformer:
    """A `repro.models.transformer.init_model` pytree -> Transformer, on
    the card unless `device` says otherwise; `trainable` turns
    requires_grad on."""
    device = require_device(device)
    lay = params["layers"]

    def take(leaf, l):
        return tensor(np.asarray(leaf)[l], device)

    def swiglu(f, l):
        return SwiGLU(take(f["w_gate"], l), take(f["w_up"], l),
                      take(f["w_down"], l))

    def ffn(l):
        if "ffn" in lay:
            return swiglu(lay["ffn"], l)
        m = lay["moe"]          # the router stays f32, as the reference's
        return MoE(take(m["router"], l), take(m["w_gate"], l),
                   take(m["w_up"], l), take(m["w_down"], l),
                   swiglu(m["shared"], l) if "shared" in m else None)

    layers = []
    for l in range(cfg.n_layers):
        a = lay["attn"]
        layers.append(Block(
            RMSNorm(take(lay["ln_attn"]["scale"], l)),
            Attention(take(a["wq"], l), take(a["wk"], l), take(a["wv"], l),
                      take(a["wo"], l)),
            RMSNorm(take(lay["ln_ffn"]["scale"], l)), ffn(l)))
    lm_head = params.get("lm_head")
    model = Transformer(tensor(params["embed"], device), layers,
                        RMSNorm(tensor(params["ln_final"]["scale"], device)),
                        tensor(lm_head, device) if lm_head is not None
                        else None)
    return set_trainable(model, trainable)


def config_from_jax(ref_cfg) -> ModelConfig:
    """A `repro.configs.base.ModelConfig` (read field by field) -> the
    port's ModelConfig with the same values."""
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    kw["dsg"] = DSGConfig(*ref_cfg.dsg)
    return ModelConfig(**kw)


def dsg_from_jax(dsg: Optional[dict], device="cuda") -> Optional[dict]:
    """A `repro.models.transformer.init_dsg` state -> the same leaves ('r'
    and 'fw', or 'fw_experts' and 'fw_shared') as tensors, on the card
    unless `device` says otherwise."""
    device = require_device(device)
    if dsg is None:
        return None
    return {k: tensor(v, device) for k, v in dsg.items()}


def _put(tree: dict, parts, leaf) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = leaf


def _get(tree: dict, parts):
    for p in parts:
        tree = tree[p]
    return tree


def to_reference_tree(flat: dict) -> dict:
    """{parameter name: tensor} (the names of `model.named_parameters()`)
    -> the reference's nested tree, on the host, with `layers.<l>.<path>`
    stacked over l into `layers/<path>`."""
    tree, stacks = {}, {}
    for name, t in flat.items():
        parts = name.split(".")
        t = t.detach().cpu()
        if parts[0] == "layers":
            stacks.setdefault(tuple(parts[2:]), []).append(t)
        else:
            _put(tree, parts, t)
    for parts, ts in stacks.items():
        _put(tree, ("layers",) + parts, torch.stack(ts))
    return tree


def _as_tensor(leaf) -> torch.Tensor:
    return leaf if torch.is_tensor(leaf) else tensor(leaf)


def from_reference_tree(tree: dict, names, device=None) -> dict:
    """The reference's nested tree (numpy or tensor leaves) -> {parameter
    name: tensor} for `names`, each stacked leaf split back into its
    layers."""
    out = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "layers":
            leaf = _as_tensor(_get(tree, ["layers"] + parts[2:]))[
                int(parts[1])]
        else:
            leaf = _as_tensor(_get(tree, parts))
        out[name] = leaf.to(device)
    return out


def state_tree(model: Transformer, dsg: Optional[dict], opt: dict,
               err: Optional[dict] = None) -> dict:
    """The trainer's state as the reference's `{'params', 'dsg', 'opt',
    'err'}` tree of host tensors (no 'dsg' without DSG, no 'err' without
    gradient compression, as the reference's pytree has no leaves there)."""
    st = {"params": to_reference_tree(dict(model.named_parameters()))}
    if dsg is not None:
        st["dsg"] = {k: v.detach().cpu() for k, v in dsg.items()}
    st["opt"] = {"step": torch.tensor(opt["step"], dtype=torch.int32),
                 "m": to_reference_tree(opt["m"]),
                 "v": to_reference_tree(opt["v"])}
    if "master" in opt:
        st["opt"]["master"] = to_reference_tree(opt["master"])
    if err is not None:
        st["err"] = to_reference_tree(err)
    return st


def _numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def state_to_numpy(model: Transformer, dsg: Optional[dict], opt: dict,
                   err: Optional[dict] = None) -> dict:
    """`state_tree` with numpy leaves (bf16 leaves widened to f32, which
    numpy can hold without ml_dtypes)."""
    def conv(t):
        return ({k: conv(v) for k, v in t.items()} if isinstance(t, dict)
                else _numpy(t))
    return conv(state_tree(model, dsg, opt, err))


def load_state_tree(tree: dict, model: Transformer, dsg: Optional[dict],
                    opt: dict, err: Optional[dict] = None) -> None:
    """Copy a `state_tree`-shaped tree (a restored checkpoint) into the
    trainer's state, in place."""
    names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        for n, t in from_reference_tree(tree["params"], names).items():
            model.get_parameter(n).copy_(t)
        if dsg is not None:
            for k, v in dsg.items():
                v.copy_(_as_tensor(tree["dsg"][k]))
        opt["step"] = int(tree["opt"]["step"])
        for key in ("m", "v", "master"):
            if key in opt:
                for n, t in from_reference_tree(tree["opt"][key],
                                                names).items():
                    opt[key][n].copy_(t)
        if err is not None:
            for n, t in from_reference_tree(tree["err"], names).items():
                err[n].copy_(t)


def opt_from_jax(opt: dict, model: Transformer, device="cuda") -> dict:
    """A `repro.optim.adamw.init_opt` state (numpy leaves) -> the port's
    AdamW state for `model`, on the card unless `device` says otherwise."""
    device = require_device(device)
    names = [n for n, _ in model.named_parameters()]
    out = {"step": int(np.asarray(opt["step"]))}
    for key in ("m", "v", "master"):
        if key in opt:
            out[key] = from_reference_tree(opt[key], names, device)
    return out
