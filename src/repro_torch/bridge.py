"""Carry the JAX package's parameters and DSG state into the port.

The reference builds its weights with JAX's PRNG, which torch cannot
replay, so a parity test builds them there, converts every leaf to numpy
(`jax.tree.map(np.asarray, params)`) and hands the nested dicts here.  The
reference stacks per-block leaves for lax.scan: (L, ...) under `layers`
for a decoder, (G, n_m, ...) under `mlstm` and (G, ...) under `slstm` for
xLSTM, (G, every, ...) under `mamba` for Zamba2, (L_enc, ...) under
`enc_layers` and (L_dec, ...) under `dec_layers` for the encoder-decoder.
The port keeps one
module per block in (nested) ModuleLists, whose parameter names carry the
indices (`layers.3.attn.wq`, `mlstm.1.2.core.w_qkv`), so the stacks are
split along their leading axes.  Each leaf keeps its own dtype (the
recurrent cores' gate weights, a_log, dt_bias, d_skip, r_diag and bias are
f32 in a bf16 model).  The DSG state keeps its stacked leaves in both
packages (fw (L, k, F); an MoE's fw_experts and fw_shared; xLSTM's fw_m
(G, n_m, k, d) and fw_s (G, k, d); Zamba2's fw_z (G, every, k, d_in) and
fw_shared (k, F); the encoder-decoder's fw_enc (L_enc, k, F) and fw_dec
(L_dec, k, F)).  `dsg_from_jax` also carries the flat dicts of
`repro.core.conv_dsg.init_conv_dsg` ({'w', 'r', 'fw'}) and
`repro.core.logit_dsg.init_logit_dsg` ({'r', 'fw'}).

The other way, `state_tree` lays the trainer's state (model, DSG state,
AdamW state, error feedback) out as the reference's tree: per-block leaves
stacked over their indices, the optimizer's `m`/`v`/`master` mirroring
`params`.  The checkpoint keys are its tree paths, and `state_to_numpy`
gives it as numpy arrays for the parity tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsg_linear import DSGConfig
from repro_torch.parallel.sharding import full_tree
from repro_torch.models import encdec, recurrent, transformer
from repro_torch.models.api import require_device
from repro_torch.models.transformer import set_trainable


def tensor(a, device=None) -> torch.Tensor:
    """numpy array (bfloat16 from ml_dtypes included) -> torch tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def model_from_jax(params: dict, cfg, device="cuda", trainable: bool = False):
    """A `repro.models.api.init_model` pytree -> the port's module for
    cfg.family (Transformer, XLSTMModel, ZambaModel or EncDecModel), on
    the card unless `device` says otherwise; `trainable` turns
    requires_grad on.  The module is built on the meta device (shapes
    only) and each parameter replaced by its leaf of `params`, which must
    hold exactly the module's leaves."""
    device = require_device(device)
    init = {"xlstm": recurrent.init_xlstm_model,
            "zamba": recurrent.init_zamba_model,
            "encdec": encdec.init_model}.get(cfg.family,
                                             transformer.init_model)
    model = init(cfg, generator=None, device="meta")
    names = [n for n, _ in model.named_parameters()]
    want = {reference_path(n)[0] for n in names}
    if want != _paths(params):
        raise ValueError(f"the reference tree's leaves "
                         f"{sorted(_paths(params) ^ want)} do not match the "
                         f"{cfg.family} model's")
    for name, t in from_reference_tree(params, names, device).items():
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner)._parameters[leaf] = nn.Parameter(
            t.clone(), requires_grad=False)
    return set_trainable(model, trainable)


def _paths(tree: dict, prefix=()) -> set:
    out = set()
    for k, v in tree.items():
        out |= (_paths(v, prefix + (k,)) if isinstance(v, dict)
                else {prefix + (k,)})
    return out


def config_from_jax(ref_cfg) -> ModelConfig:
    """A `repro.configs.base.ModelConfig` (read field by field) -> the
    port's ModelConfig with the same values."""
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    kw["dsg"] = DSGConfig(*ref_cfg.dsg)
    return ModelConfig(**kw)


def dsg_from_jax(dsg: Optional[dict], device="cuda") -> Optional[dict]:
    """A reference DSG state (any family's `init_dsg`, or the flat dicts of
    `init_conv_dsg` and `init_logit_dsg`) -> the same leaves as tensors,
    on the card unless `device` says otherwise."""
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


def reference_path(name: str):
    """A parameter name -> (its path in the reference's tree, block
    indices): `mlstm.1.2.core.w` -> (('mlstm', 'core', 'w'), (1, 2)); a
    name with no indices has ().  The reference stacks the leaf over as
    many leading dims as there are indices."""
    parts = name.split(".")
    i = 1
    while i < len(parts) and parts[i].isdigit():
        i += 1
    return (parts[0],) + tuple(parts[i:]), tuple(int(p) for p in parts[1:i])


def to_reference_tree(flat: dict) -> dict:
    """{parameter name: tensor} (the names of `model.named_parameters()`)
    -> the reference's nested tree, on the host (meta tensors stay meta),
    each block leaf stacked over its indices (`layers.<l>.<path>` into `layers/<path>` (L, ...),
    `mlstm.<g>.<l>.<path>` into `mlstm/<path>` (G, n_m, ...))."""
    tree, stacks = {}, {}
    for name, t in flat.items():
        path, idx = reference_path(name)
        t = t.detach() if t.is_meta else full_tree(t.detach()).cpu()
        if idx:
            stacks.setdefault(path, []).append((idx, t))
        else:
            _put(tree, path, t)
    for path, items in stacks.items():
        items.sort(key=lambda it: it[0])
        grid = tuple(max(i[a] for i, _ in items) + 1
                     for a in range(len(items[0][0])))
        stacked = torch.stack([t for _, t in items])
        _put(tree, path, stacked.reshape(grid + stacked.shape[1:]))
    return tree


def _assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst.copy_(src) for a whole `src`; a DTensor `dst` takes its own
    shards of it."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(dst, DTensor):
        src = distribute_tensor(src.to(dst.to_local().device),
                                dst.device_mesh, dst.placements)
    dst.copy_(src)


def _as_tensor(leaf) -> torch.Tensor:
    return leaf if torch.is_tensor(leaf) else tensor(leaf)


def from_reference_tree(tree: dict, names, device=None) -> dict:
    """The reference's nested tree (numpy or tensor leaves) -> {parameter
    name: tensor} for `names`, each stacked leaf split back into its
    blocks."""
    out = {}
    for name in names:
        path, idx = reference_path(name)
        out[name] = _as_tensor(_get(tree, path))[idx].to(device)
    return out


def state_tree(model: nn.Module, dsg: Optional[dict], opt: dict,
               err: Optional[dict] = None) -> dict:
    """The trainer's state as the reference's `{'params', 'dsg', 'opt',
    'err'}` tree of host tensors (no 'dsg' without DSG, no 'err' without
    gradient compression, as the reference's pytree has no leaves there).
    DTensor leaves (a sharded trainer's) are gathered whole, a collective
    every rank of their mesh takes part in."""
    st = {"params": to_reference_tree(dict(model.named_parameters()))}
    if dsg is not None:
        st["dsg"] = {k: full_tree(v.detach()).cpu() for k, v in dsg.items()}
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


def state_to_numpy(model: nn.Module, dsg: Optional[dict], opt: dict,
                   err: Optional[dict] = None) -> dict:
    """`state_tree` with numpy leaves (bf16 leaves widened to f32, which
    numpy can hold without ml_dtypes)."""
    def conv(t):
        return ({k: conv(v) for k, v in t.items()} if isinstance(t, dict)
                else _numpy(t))
    return conv(state_tree(model, dsg, opt, err))


def load_state_tree(tree: dict, model: nn.Module, dsg: Optional[dict],
                    opt: dict, err: Optional[dict] = None) -> None:
    """Copy a `state_tree`-shaped tree (a restored checkpoint) into the
    trainer's state, in place; a DTensor leaf takes its own shards."""
    names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        for n, t in from_reference_tree(tree["params"], names).items():
            _assign(model.get_parameter(n), t)
        if dsg is not None:
            for k, v in dsg.items():
                _assign(v, _as_tensor(tree["dsg"][k]))
        opt["step"] = int(tree["opt"]["step"])
        for key in ("m", "v", "master"):
            if key in opt:
                for n, t in from_reference_tree(tree["opt"][key],
                                                names).items():
                    _assign(opt[key][n], t)
        if err is not None:
            for n, t in from_reference_tree(tree["err"], names).items():
                _assign(err[n], t)


def opt_from_jax(opt: dict, model: nn.Module, device="cuda") -> dict:
    """A `repro.optim.adamw.init_opt` state (numpy leaves) -> the port's
    AdamW state for `model`, on the card unless `device` says otherwise."""
    device = require_device(device)
    names = [n for n, _ in model.named_parameters()]
    out = {"step": int(np.asarray(opt["step"]))}
    for key in ("m", "v", "master"):
        if key in opt:
            out[key] = from_reference_tree(opt[key], names, device)
    return out
