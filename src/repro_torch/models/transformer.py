"""Decoder-only transformer (dense family): an nn.ModuleList of pre-norm
blocks run by a Python loop over layers, where the reference scans stacked
layer leaves with lax.scan.

The DSG state is a dict: one shared projection R (k, d) and the per-layer
projected search weights fw (L, k, F).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dsg_linear as dl
from repro_torch.core import projection
from repro_torch.models import attention as attn
from repro_torch.models.layers import RMSNorm, embed_init, norm_init


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Block(nn.Module):
    def __init__(self, ln_attn: RMSNorm, attn_p: attn.Attention,
                 ln_ffn: RMSNorm, ffn: dl.SwiGLU):
        super().__init__()
        self.ln_attn = ln_attn
        self.attn = attn_p
        self.ln_ffn = ln_ffn
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


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.norm != "rmsnorm" or cfg.act != "swiglu":
        raise NotImplementedError(
            f"the port runs the dense rmsnorm/swiglu family only, not "
            f"{cfg.family}/{cfg.norm}/{cfg.act} (see ROADMAP.md)")


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
                    dl.init_swiglu(cfg.d_model, cfg.d_ff, **kw))
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
    stacked (L, k, F)."""
    if not cfg.dsg.enabled:
        return None
    k = dl.proj_dim(cfg.d_model, cfg.d_ff, cfg.dsg)
    r = projection.make_projection(k, cfg.d_model, generator=generator,
                                   dtype=torch_dtype(cfg), device=device)
    fw = torch.stack([r @ blk.ffn.w_gate for blk in model.layers])
    return {"r": r, "fw": fw}


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
           page_table, live_pages, r, fw_l, csr_l, collect_scores: bool):
    h = blk.ln_attn(x)
    a, _ = attn.self_attention(
        blk.attn, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        rope_theta=cfg.rope_theta, q_pos=q_pos, causal=True,
        window=cfg.window, cache=cache_l, cache_pos=cache_pos,
        page_table=page_table, live_pages=live_pages,
        paged_kernel=cfg.paged_attn_kernel, bf16_scores=cfg.attn_bf16_scores)
    x = x + a
    h = blk.ln_ffn(x)
    scores = _drs_scores(h, r, fw_l, cfg) if collect_scores else None
    if csr_l is not None:
        f = dl.swiglu_csr(blk.ffn, h, csr_l[0], csr_l[1], block=cfg.dsg.block,
                          apply=cfg.dsg_ffn_apply)
    else:
        st = {"r": r, "fw": fw_l} if fw_l is not None else None
        f = dl.swiglu_ffn(blk.ffn, h, st, cfg.dsg)
    return x + f, scores


def forward(model: Transformer, dsg: Optional[dict], cfg: ModelConfig,
            tokens: torch.Tensor, *, cache: Optional[dict] = None, pos0=0,
            live_pages: Optional[int] = None, last_only: bool = False,
            ffn_csr: Optional[dict] = None,
            collect_drs_scores: bool = False):
    """tokens (B, S) -> (logits, cache) [+ DRS scores (L, B, S, G) when
    collect_drs_scores].

    cache: a dense cache {'k', 'v'} of (L, B, Smax, Kv, D) with pos0 an
    int, or the paged view {'pages_k', 'pages_v', 'page_table'} with pos0
    the per-lane (B,) int32 depths.  Caches are updated in place and
    returned.  ffn_csr: per-layer group-CSR selections {'idx': (L, B, K),
    'counts': (L, B)}; the FFN then contracts only the listed groups.
    live_pages bounds the paged walk (None walks the whole table).
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
    x = model.embed[tokens]
    s = x.shape[1]
    steps = torch.arange(s, device=x.device)
    if torch.is_tensor(pos0):
        q_pos = pos0[:, None].long() + steps
    else:
        q_pos = pos0 + steps
    r = dsg["r"] if dsg is not None else None
    all_scores = []
    for l, blk in enumerate(model.layers):
        csr_l = ((ffn_csr["idx"][l], ffn_csr["counts"][l])
                 if ffn_csr is not None else None)
        x, scores = _block(blk, x, cfg, q_pos, layer_caches[l], pos0,
                           page_table, live_pages, r,
                           dsg["fw"][l] if dsg is not None else None, csr_l,
                           collect_drs_scores)
        all_scores.append(scores)
    x = model.ln_final(x)
    if last_only:
        x = x[:, -1:]
    head = model.embed.t() if model.lm_head is None else model.lm_head
    logits = x @ head
    if collect_drs_scores:
        return logits, cache, torch.stack(all_scores)
    return logits, cache


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


def prefill(model, dsg, cfg: ModelConfig, tokens, cache,
            collect_drs_scores: bool = False):
    """Prefill `cache` with the prompt; returns (last_logits (B, V), cache)
    [+ the last token's DRS scores (L, B, G)]."""
    out = forward(model, dsg, cfg, tokens, cache=cache, pos0=0,
                  last_only=True, collect_drs_scores=collect_drs_scores)
    if collect_drs_scores:
        logits, cache, scores = out
        return logits[:, -1], cache, scores[:, :, -1]
    logits, cache = out
    return logits[:, -1], cache


def decode_step(model, dsg, cfg: ModelConfig, token, cache, pos,
                live_pages=None, ffn_csr=None,
                collect_drs_scores: bool = False):
    """One decode step: token (B, 1), pos (B,) int32 -> (logits (B, V),
    cache) [+ DRS scores (L, B, G)]."""
    out = forward(model, dsg, cfg, token, cache=cache, pos0=pos,
                  live_pages=live_pages, ffn_csr=ffn_csr,
                  collect_drs_scores=collect_drs_scores)
    if collect_drs_scores:
        logits, cache, scores = out
        return logits[:, -1], cache, scores[:, :, 0]
    logits, cache = out
    return logits[:, -1], cache
