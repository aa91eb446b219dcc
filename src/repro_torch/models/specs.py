"""Partition specs for the parameters, DSG state, caches and inputs (the
port of `repro.models.specs`), with the reference's per-family rules.

The reference stacks per-block leaves over leading dims (L; G, n_m;
G, every; L_enc / L_dec) and always replicates those dims.  The port keeps
one module per block, so a parameter's spec is the reference's for the
stacked leaf with the stacked entries dropped: the rule runs on the leaf's
shape behind as many stacked dims as `bridge.reference_path` finds block
indices in its name.  The DSG state, caches and inputs are stacked the
same way in both packages, so their rules are the reference's as they
are.  A spec of P() means fully replicated; on a 1-device mesh every rule
gives P() or entries that name no axis of size > 1.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.bridge import reference_path
from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import P, Axes


def _div(n: int, shards: int) -> bool:
    return shards > 0 and n % shards == 0


def _attn_mode(cfg: ModelConfig, n_model: int) -> str:
    if n_model <= 1:
        return "none"
    if cfg.attn_shard != "auto":
        return cfg.attn_shard
    return "head" if cfg.n_heads % n_model == 0 else "seq"


def _param_rule(names: tuple, shape: tuple, cfg: ModelConfig, m,
                mode: str, n_model: int) -> P:
    """The reference's rule for the leaf at tree path `names` of the
    reference's (stacked) `shape`."""
    ndim = len(shape)
    name = names[-1]
    lead = (None,) * (ndim - 2)     # layer-stack prefix dims
    # ---- embeddings / heads -------------------------------------------
    if name in ("embed", "tok_embed"):
        return P(m, None) if _div(cfg.vocab, n_model) else P()
    if name == "lm_head":
        return P(None, m) if _div(cfg.vocab, n_model) else P()
    # ---- norms / scalars ----------------------------------------------
    if name in ("scale", "bias", "a_log", "dt_bias", "d_skip",
                "b_gates", "skip", "r_diag", "conv_w", "router"):
        return P()
    # ---- attention ----------------------------------------------------
    if names[-2] in ("attn", "cross") or name in ("wq", "wk", "wv", "wo"):
        if mode == "head":
            if name == "wq":
                return P(*lead[:-1], None, m, None)
            if name in ("wk", "wv"):
                ok = _div(cfg.n_kv, n_model)
                return P(*lead[:-1], None, m, None) if ok else P()
            if name == "wo":
                return P(*lead[:-1], m, None, None)
        return P()   # seq mode: weights replicated, activations S-sharded
    # ---- FFN (dense swiglu / gelu; also zamba shared) ------------------
    if name in ("w_gate", "w_up") and ndim - len(lead) == 2 \
            and "moe" not in names:
        return P(*lead, None, m) if _div(shape[-1], n_model) else P()
    if name == "w_down" and "moe" not in names:
        return P(*lead, m, None) if _div(shape[-2], n_model) else P()
    # ---- MoE ------------------------------------------------------------
    if "moe" in names and "shared" in names:
        if name in ("w_gate", "w_up"):
            return P(*lead, None, m) if _div(shape[-1], n_model) else P()
        if name == "w_down":
            return P(*lead, m, None) if _div(shape[-2], n_model) else P()
    if "moe" in names and name in ("w_gate", "w_up", "w_down"):
        e = shape[len(lead) - 1] if ndim >= 3 else 0
        # (L, E, d, f): experts over 'model' (EP)
        return P(*lead[:-1], m, None, None) if _div(e, n_model) else P()
    # ---- recurrent-family projections (row/col parallel) ---------------
    if name in ("w_z", "w_x", "conv_x"):   # mamba2 head-parallel columns;
        # the depthwise conv follows its channels
        return P(*lead, None, m) if _div(shape[-1], n_model) else P()
    if name in ("w_bcdt", "conv_bc"):
        return P()
    if name in ("w_in", "w_qkv", "w_out", "w_gates"):   # row-parallel
        return P(*lead, m, None) if _div(shape[-2], n_model) else P()
    return P()


def param_specs(model, cfg: ModelConfig, ax: Axes, n_model: int) -> dict:
    """{parameter name: spec} for every parameter of `model`."""
    m = ax.model if n_model > 1 else None
    mode = _attn_mode(cfg, n_model)
    out = {}
    for name, p in model.named_parameters():
        path, idx = reference_path(name)
        depth = len(idx)
        spec = _param_rule(path, (1,) * depth + tuple(p.shape), cfg, m,
                           mode, n_model)
        if spec:                     # full length: drop the stacked dims
            if any(e is not None for e in spec[:depth]):
                raise RuntimeError(f"{name}: stacked dims of {spec} are "
                                   f"sharded")
            spec = P(*spec[depth:])
        out[name] = spec
    return out


def dsg_specs(dsg: Optional[dict], cfg: ModelConfig, ax: Axes,
              n_model: int) -> Optional[dict]:
    if dsg is None:
        return None
    m = ax.model if n_model > 1 else None

    def rule(name, leaf):
        if name == "r":
            return P()
        if name == "fw_experts":      # (L, E, k, fe): follow experts
            e = leaf.shape[1]
            return P(None, m, None, None) if _div(e, n_model) else P()
        # (.., k, F): follow FFN column sharding when F divides
        lead = (None,) * (leaf.ndim - 2)
        return P(*lead, None, m) if _div(leaf.shape[-1], n_model) else P()

    return {k: rule(k, v) for k, v in dsg.items()}


def _tree_map(fn, tree, path=()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def cache_specs(cache, cfg: ModelConfig, ax: Axes, n_model: int):
    """Decode caches: KV sequence-sharded over 'model' (split-KV decode);
    recurrent states batch-sharded only."""
    m = ax.model if n_model > 1 else None
    b = ax.batch

    def rule(path, leaf):
        name = path[-1]
        if name in ("k", "v"):
            lead = (None,) * (leaf.ndim - 4)
            # (..., B, S, Kv, D)
            return P(*lead, b, m, None, None)
        # recurrent states: (..., B, ...) behind their stack dims
        if name in ("ssm", "conv_x", "conv_bc", "m_c", "m_n",
                    "c", "n", "m", "h"):
            idx = {"ssm": 2, "conv_x": 2, "conv_bc": 2,
                   "m_c": 2, "m_n": 2}.get(name, leaf.ndim - 2)
            entries = [None] * leaf.ndim
            entries[idx] = b
            return P(*entries)
        return P()

    return _tree_map(rule, cache)


def input_specs(batch: dict, cfg: ModelConfig, ax: Axes) -> dict:
    """Every input is batch-major."""
    return {k: P(ax.batch, *([None] * (v.ndim - 1)))
            for k, v in batch.items()}
