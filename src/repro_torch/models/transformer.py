"""Decoder-only transformer (dense, MoE and VLM families): an
nn.ModuleList of pre-norm blocks run by a Python loop over layers, where
the reference scans stacked layer leaves with lax.scan.  A block's FFN is
a SwiGLU (`ffn`) or, in the MoE family, a mixture of experts (`moe`,
`models/moe.py`); the VLM family prepends stub patch embeddings
(`prefix_embeds`) to the token embeddings.

The DSG state is a dict: one shared projection R (k, d) and the per-layer
projected search weights, recomputed from the current gate weights by
`refresh_dsg` (the training loop's f(W) refresh): fw (L, k, F) for a
SwiGLU, or fw_experts (L, E, k, F_e) and, with shared experts, fw_shared
(L, k, n_shared · F_e) for an MoE.

Weights are built with requires_grad off; the trainer turns it on for the
model it owns (`set_trainable`).  The serving entry points (`prefill`,
`decode_step`) run under torch.no_grad(), so a trained model serves, and a
captured CUDA graph records, no autograd.  Training calls `forward` with
no cache; with cfg.remat each layer is then recomputed in the backward
(torch.utils.checkpoint), as the reference's jax.checkpoint does.

Sharded: with the weights laid out as DTensors (`parallel.sharding.
distribute_model`), the verbs take the reference's `mesh` and
`batch_axes` and run under `parallel.context.use_mesh(mesh)`; DTensor
carries the layout through the ops, the attention places its activations
as the reference's constraints do, a MoE runs its experts in parallel
over 'model', and a gather_shared FFN selects per 'model' shard.  Run a
backward under the same context (remat recomputes layers there).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dsg_linear as dl
from repro_torch.core import projection
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import RMSNorm, embed_init, norm_init
from repro_torch.parallel import context as pctx
from repro_torch.parallel.sharding import is_dtensor


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Block(nn.Module):
    """One pre-norm block; `ffn` is a SwiGLU, held as `ffn`, or an MoE,
    held as `moe` (the reference's leaf names)."""

    def __init__(self, ln_attn: RMSNorm, attn_p: attn.Attention,
                 ln_ffn: RMSNorm, ffn):
        super().__init__()
        self.ln_attn = ln_attn
        self.attn = attn_p
        self.ln_ffn = ln_ffn
        if isinstance(ffn, moe_mod.MoE):
            self.moe = ffn
        else:
            self.ffn = ffn


class Transformer(nn.Module):
    def __init__(self, embed: torch.Tensor, layers, ln_final: RMSNorm,
                 lm_head: Optional[torch.Tensor]):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)     # (V, d)
        self.layers = nn.ModuleList(layers)
        self.ln_final = ln_final
        self.lm_head = (nn.Parameter(lm_head, requires_grad=False)
                        if lm_head is not None else None)         # (d, V)


def set_trainable(model: Transformer, flag: bool = True) -> Transformer:
    """Turn requires_grad on (or off) for every parameter of `model`."""
    for p in model.parameters():
        p.requires_grad_(flag)
    return model


DECODER_FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if (cfg.family not in DECODER_FAMILIES or cfg.norm != "rmsnorm"
            or cfg.act != "swiglu"):
        raise NotImplementedError(
            f"the port's decoder runs the rmsnorm/swiglu decoder families "
            f"{DECODER_FAMILIES}, not {cfg.family}/{cfg.norm}/{cfg.act} "
            f"(every decoder config of the reference is rmsnorm/swiglu)")


def _init_ffn(cfg: ModelConfig, kw: dict):
    if cfg.is_moe:
        return moe_mod.init_moe(cfg.d_model, cfg.moe_experts, cfg.moe_d_ff,
                                cfg.moe_shared, **kw)
    return dl.init_swiglu(cfg.d_model, cfg.d_ff, **kw)


def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device=None) -> Transformer:
    """Random weights from `generator` (created on `device`), with the
    reference's scales."""
    _check_family(cfg)
    dt = torch_dtype(cfg)
    kw = dict(generator=generator, dtype=dt, device=device)
    layers = [Block(norm_init(cfg.d_model, dtype=dt, device=device),
                    attn.init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv,
                                        cfg.head_dim, **kw),
                    norm_init(cfg.d_model, dtype=dt, device=device),
                    _init_ffn(cfg, kw))
              for _ in range(cfg.n_layers)]
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = (torch.randn((cfg.d_model, cfg.vocab), generator=generator,
                               device=device)
                   / math.sqrt(cfg.d_model)).to(dt)
    return Transformer(embed_init(cfg.vocab, cfg.d_model, **kw), layers,
                       norm_init(cfg.d_model, dtype=dt, device=device),
                       lm_head)


def init_dsg(model: Transformer, cfg: ModelConfig, *,
             generator: torch.Generator, device=None) -> Optional[dict]:
    """DSG buffers: shared R (k, d) and per-layer f(W) = R @ w_gate,
    stacked over layers (for an MoE, per expert; k from the expert
    width)."""
    if not cfg.dsg.enabled:
        return None
    k = dl.proj_dim(cfg.d_model, cfg.moe_d_ff if cfg.is_moe else cfg.d_ff,
                    cfg.dsg)
    r = projection.make_projection(k, cfg.d_model, generator=generator,
                                   dtype=torch_dtype(cfg), device=device)
    return refresh_dsg({"r": r}, model, cfg)


def refresh_dsg(dsg: Optional[dict], model: Transformer,
                cfg: ModelConfig) -> Optional[dict]:
    """f(W) recomputed from the current gate weights (the paper refreshes
    every 50 steps); R is kept.  Not differentiated."""
    if dsg is None:
        return None
    r = dsg["r"]
    with torch.no_grad():
        if not cfg.is_moe:
            return {"r": r, "fw": torch.stack(
                [r @ dl.search_weight(blk.ffn) for blk in model.layers])}
        out = {"r": r, "fw_experts": torch.stack(
            [torch.matmul(r, blk.moe.w_gate) for blk in model.layers])}
        if model.layers[0].moe.shared is not None:
            out["fw_shared"] = torch.stack(
                [r @ dl.search_weight(blk.moe.shared)
                 for blk in model.layers])
        return out


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table[tokens].  A DTensor table is looked up in a shard_map over the
    parallel context's mesh, in plain tensors: a vocab-sharded one as the
    vocab-parallel embedding does it (each 'model' shard gives the rows of
    its own vocabulary range, zeros elsewhere, summed over 'model'), so no
    DTensor index op (and its scatter-add backward) runs."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Shard
    from repro_torch.parallel.collectives import axis_index, psum, shard_map
    from repro_torch.parallel.sharding import P
    ctx = pctx.current()
    by_vocab = any(isinstance(p, Shard) and p.dim == 0
                   for p in table.placements)

    def body(t_l, ids):
        if not by_vocab:
            return t_l[ids]
        rows = t_l.shape[0]
        local = ids - axis_index("model", ctx.mesh) * rows
        inside = (local >= 0) & (local < rows)
        out = torch.where(inside[..., None], t_l[local.clamp(0, rows - 1)],
                          0.0)
        return psum(out, "model", ctx.mesh)

    ba = ctx.ax.batch
    nd = (None,) * (tokens.ndim - 1)
    return shard_map(body, ctx.mesh,
                     (P("model", None) if by_vocab else P(), P(ba, *nd)),
                     P(ba, *nd, None))(table, pctx.replicated(tokens))


def _layer_dsg(dsg: Optional[dict], l: int) -> Optional[dict]:
    """Layer l's slice of the per-layer DSG leaves (R stays shared)."""
    if dsg is None:
        return None
    return {k: v[l] for k, v in dsg.items() if k != "r"}


def _ffn_apply(blk: Block, h, cfg: ModelConfig, r, dsg_l, csr_l,
               aux_kind, mesh=None, batch_axes=None):
    """FFN or MoE with DSG; returns (y, aux or None).  csr_l: this layer's
    group-CSR selection (idx (B, K), counts (B,)) from the serving DSG
    runtime, which targets the SwiGLU FFN only."""
    if csr_l is not None:
        if cfg.is_moe:
            raise NotImplementedError(
                "group-CSR serving selection targets the dense-FFN "
                "family; MoE experts are already conditional compute")
        return dl.swiglu_csr(blk.ffn, h, csr_l[0], csr_l[1],
                             block=cfg.dsg.block,
                             apply=cfg.dsg_ffn_apply), None
    if cfg.is_moe:
        st = None
        if dsg_l is not None:
            st = {"r": r, "fw_experts": dsg_l["fw_experts"]}
            if "fw_shared" in dsg_l:
                st["shared"] = {"r": r, "fw": dsg_l["fw_shared"]}
        return moe_mod.moe_ffn(
            blk.moe, h, n_experts=cfg.moe_experts, top_k=cfg.moe_topk,
            capacity_factor=cfg.moe_capacity_factor, dsg=cfg.dsg,
            dsg_state=st, mesh=mesh, batch_axes=batch_axes,
            aux_kind=aux_kind)
    st = {"r": r, "fw": dsg_l["fw"]} if dsg_l is not None else None
    return dl.swiglu_ffn(blk.ffn, h, st, cfg.dsg), None


def _drs_scores(h: torch.Tensor, r: torch.Tensor, fw: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """DRS group scores of the FFN input h (B, S, d) -> (B, S, G) through
    the search kernels: f(h) = h @ R^T in R's dtype (so at bf16 width the
    scores see f(h) rounded to bf16), then the fused relu-sum scores."""
    from repro_torch.kernels import ops
    b, s, d = h.shape
    fx = ops.drs_project(h.reshape(b * s, d).to(r.dtype).contiguous(), r)
    scores = ops.drs_scores(fx, fw, block=cfg.dsg.block)
    return scores.reshape(b, s, -1)


def _block(blk: Block, x, cfg: ModelConfig, q_pos, cache_l, cache_pos,
           page_table, live_pages, r, dsg_l, csr_l, collect_scores: bool,
           aux_kind=None, mesh=None, batch_axes=None):
    if cfg.seq_sharded_residual:
        # Megatron-SP: the residual stream (the remat stash) seq-sharded
        x = pctx.constrain(x, pctx.batch_axes(), "model", None)
    h = blk.ln_attn(x)
    a, _ = attn.self_attention(
        blk.attn, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        rope_theta=cfg.rope_theta, q_pos=q_pos, causal=True,
        window=cfg.window, cache=cache_l, cache_pos=cache_pos,
        page_table=page_table, live_pages=live_pages,
        paged_kernel=cfg.paged_attn_kernel, shard=cfg.attn_shard,
        bf16_scores=cfg.attn_bf16_scores)
    x = x + a
    h = blk.ln_ffn(x)
    scores = _drs_scores(h, r, dsg_l["fw"], cfg) if collect_scores else None
    f, aux = _ffn_apply(blk, h, cfg, r, dsg_l, csr_l, aux_kind, mesh,
                        batch_axes)
    x = x + f
    if cfg.seq_sharded_residual:
        x = pctx.constrain(x, pctx.batch_axes(), "model", None)
    return x, scores, aux


def forward(model: Transformer, dsg: Optional[dict], cfg: ModelConfig,
            tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None, pos0=0,
            live_pages: Optional[int] = None, last_only: bool = False,
            ffn_csr: Optional[dict] = None,
            collect_drs_scores: bool = False, with_aux: bool = False,
            mesh=None, batch_axes=None):
    """tokens (B, S) -> (logits, cache) [+ DRS scores (L, B, S, G) when
    collect_drs_scores] [+ the auxiliary loss summed over layers, a 0-dim
    f32 tensor, when with_aux].

    prefix_embeds (B, P, d): VLM stub patch embeddings, prepended to the
    token embeddings (logits then cover P + S positions).

    cache: a dense cache {'k', 'v'} of (L, B, Smax, Kv, D) with pos0 an
    int, or the paged view {'pages_k', 'pages_v', 'page_table'} with pos0
    the per-lane (B,) int32 depths.  Caches are updated in place and
    returned.  ffn_csr: per-layer group-CSR selections {'idx': (L, B, K),
    'counts': (L, B)}; the FFN then contracts only the listed groups.
    live_pages bounds the paged walk (None walks the whole table).
    mesh / batch_axes: the reference's arguments for a sharded run (the
    MoE's expert parallelism reads them); the caller installs the mesh's
    parallel context.
    """
    _check_family(cfg)
    page_table = None
    layer_caches = [None] * cfg.n_layers
    if cache is not None and "page_table" in cache:
        page_table = cache["page_table"]
        layer_caches = [{"k": cache["pages_k"][l], "v": cache["pages_v"][l]}
                        for l in range(cfg.n_layers)]
    elif cache is not None:
        layer_caches = [{"k": cache["k"][l], "v": cache["v"][l]}
                        for l in range(cfg.n_layers)]
    x = embed_tokens(model.embed, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    s = x.shape[1]
    steps = torch.arange(s, device=x.device)
    if torch.is_tensor(pos0):
        q_pos = pos0[:, None].long() + steps
    else:
        q_pos = pos0 + steps
    r = dsg["r"] if dsg is not None else None
    # per-layer rematerialisation when a backward will follow: each block
    # keeps only its input and runs again in the backward.  The block
    # draws nothing at random, so the recomputed DRS mask is the forward's
    remat = (cfg.remat and cache is None and torch.is_grad_enabled()
             and any(p.requires_grad for p in model.parameters()))
    aux_kind = cfg.moe_aux if (with_aux and cfg.is_moe) else None
    all_scores, aux = [], None
    for l, blk in enumerate(model.layers):
        csr_l = ((ffn_csr["idx"][l], ffn_csr["counts"][l])
                 if ffn_csr is not None else None)
        args = (blk, x, cfg, q_pos, layer_caches[l], pos0, page_table,
                live_pages, r, _layer_dsg(dsg, l), csr_l, collect_drs_scores,
                aux_kind, mesh, batch_axes)
        if remat:
            x, scores, aux_l = checkpoint(_block, *args, use_reentrant=False)
        else:
            x, scores, aux_l = _block(*args)
        all_scores.append(scores)
        if aux_l is not None:
            aux = aux_l if aux is None else aux + aux_l
    x = model.ln_final(x)
    if last_only:
        x = x[:, -1:]
    head = model.embed.t() if model.lm_head is None else model.lm_head
    out = (x @ head, cache)
    if collect_drs_scores:
        out += (torch.stack(all_scores),)
    if with_aux:
        out += (torch.zeros((), device=x.device) if aux is None else aux,)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype, device=None) -> dict:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype: torch.dtype, device=None) -> dict:
    """Physical page pools, K/V each (L, n_pages, page_size, Kv, D)."""
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy, computed in f32 (logsumexp minus the gold
    logit); `mask` weights the tokens."""
    logits = logits.float()
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = torch.logsumexp(logits, dim=-1) - gold
    if mask is not None:
        return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce.mean()


def sharded_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """`cross_entropy` inside a parallel context.  Logits whose vocab is
    split over 'model' take Megatron's vocab-parallel form, a shard_map
    body over the vocab shards: each rank's max over its shard, reduced
    by max over 'model'; its sum of exp(logit - max), summed over
    'model'; the gold logit from the rank whose shard holds the label
    (zero elsewhere), summed over 'model'; ce = log(sum) + max - gold, in
    f32.  No rank holds more than its own (rows, S, V / model) block,
    forward or backward: logits laid out otherwise are split over the
    vocab first.  Where 'model' does not divide the vocab they are
    reduced as they are; outside a context, or on a model axis of 1,
    this is `cross_entropy`."""
    ctx = pctx.current()
    if not (is_dtensor(logits) and ctx is not None and ctx.n_model > 1
            and logits.shape[-1] % ctx.n_model == 0):
        logits = pctx.constrain(logits, pctx.batch_axes(),
                                *([None] * (logits.ndim - 1)))
        return cross_entropy(logits, labels, mask)
    from repro_torch.parallel.collectives import (axis_index, pmax, psum,
                                                  shard_map)
    from repro_torch.parallel.sharding import P
    mesh, ba = ctx.mesh, ctx.ax.batch

    def body(lg, lab):
        lg = lg.float()
        rows = lg.shape[-1]
        top = pmax(lg.amax(dim=-1), "model", mesh)
        total = psum(torch.exp(lg - top[..., None]).sum(dim=-1), "model",
                     mesh)
        local = lab.long() - axis_index("model", mesh) * rows
        inside = (local >= 0) & (local < rows)
        gold = torch.gather(lg, -1, local.clamp(0, rows - 1)[..., None])
        gold = psum(torch.where(inside, gold[..., 0], 0.0), "model", mesh)
        return torch.log(total) + top - gold

    nd = (None,) * (labels.ndim - 1)
    ce = shard_map(body, mesh, (P(ba, *nd, "model"), P(ba, *nd)),
                   P(ba, *nd))(logits, pctx.replicated(labels))
    if mask is not None:
        mask = pctx.replicated(mask)
        return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce.mean()


def train_loss(model: Transformer, dsg: Optional[dict], cfg: ModelConfig,
               batch: dict, mesh=None, batch_axes=None) -> torch.Tensor:
    """Next-token loss of batch {'tokens', 'labels'} (B, S) (with
    'prefix_embeds' (B, P, d) for a VLM, whose P prefix positions are cut
    from the logits), plus 0.01 x the auxiliary loss summed over layers
    (the MoE's load balance; zero for the other families)."""
    prefix = batch.get("prefix_embeds")
    logits, _, aux = forward(model, dsg, cfg, batch["tokens"],
                             prefix_embeds=prefix, with_aux=True, mesh=mesh,
                             batch_axes=batch_axes)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    return sharded_cross_entropy(logits, batch["labels"]) + 0.01 * aux


@torch.no_grad()
def prefill(model, dsg, cfg: ModelConfig, tokens, cache,
            prefix_embeds=None, collect_drs_scores: bool = False,
            mesh=None, batch_axes=None):
    """Prefill `cache` with the prompt (after `prefix_embeds`, when
    given); returns (last_logits (B, V), cache) [+ the last token's DRS
    scores (L, B, G)]."""
    out = forward(model, dsg, cfg, tokens, prefix_embeds=prefix_embeds,
                  cache=cache, pos0=0, last_only=True,
                  collect_drs_scores=collect_drs_scores, mesh=mesh,
                  batch_axes=batch_axes)
    if collect_drs_scores:
        logits, cache, scores = out
        return logits[:, -1], cache, scores[:, :, -1]
    logits, cache = out
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(model, dsg, cfg: ModelConfig, token, cache, pos,
                live_pages=None, ffn_csr=None,
                collect_drs_scores: bool = False, mesh=None,
                batch_axes=None):
    """One decode step: token (B, 1), pos (B,) int32 -> (logits (B, V),
    cache) [+ DRS scores (L, B, G)]."""
    out = forward(model, dsg, cfg, token, cache=cache, pos0=pos,
                  live_pages=live_pages, ffn_csr=ffn_csr,
                  collect_drs_scores=collect_drs_scores, mesh=mesh,
                  batch_axes=batch_axes)
    if collect_drs_scores:
        logits, cache, scores = out
        return logits[:, -1], cache, scores[:, :, 0]
    logits, cache = out
    return logits[:, -1], cache
