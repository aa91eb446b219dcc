"""Encoder-decoder transformer (the whisper-large-v3 backbone): the port of
`repro.models.encdec`.

The audio frontend (mel filterbank and strided conv stem) is a stub, as in
the reference: `api.make_inputs` gives frame embeddings (B, S, d) straight
to the encoder.  For a shape of seq_len S the encoder takes S frames and
the decoder S // dec_ratio tokens; decode steps attend over the whole
encoder memory through cross-attention on K/V computed once at prefill
(`build_memory_kv`).

The reference stacks each stack's layer leaves (L, ...) and scans them;
the port holds `enc_layers` and `dec_layers` as ModuleLists run by Python
loops.  Norms are layer norms (`cfg.norm`), the FFNs GELU FFNs with DSG on
the up projection (`dsg_linear.gelu_ffn`).  Only the two self-attentions
rotate (RoPE); the encoder's is bidirectional.  Every score is f32: the
reference passes no `bf16_scores` to any attention here, whatever
`cfg.attn_bf16_scores` says.

The DSG state is {'r': (k, d), 'fw_enc': (L_enc, k, F), 'fw_dec': (L_dec,
k, F)}, f(W) = R @ w_up per layer.  The decoder's dense self-attention
cache {'k', 'v'} (L, B, max_dec, Kv, D) is written in place, as the
port's caches are; the reference returns new arrays.  With cfg.remat a
training forward recomputes each layer in the backward
(`torch.utils.checkpoint`), as the reference's jax.checkpoint does.
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
from repro_torch.models.layers import embed_init, norm_apply, norm_init
from repro_torch.models.transformer import (embed_tokens,
                                           sharded_cross_entropy, torch_dtype)


class EncLayer(nn.Module):
    def __init__(self, ln_attn, attn_p, ln_ffn, ffn):
        super().__init__()
        self.ln_attn = ln_attn
        self.attn = attn_p
        self.ln_ffn = ln_ffn
        self.ffn = ffn


class DecLayer(EncLayer):
    """An encoder layer's leaves plus cross-attention (`cross`) and its
    norm (`ln_cross`)."""

    def __init__(self, ln_attn, attn_p, ln_ffn, ffn, ln_cross, cross):
        super().__init__(ln_attn, attn_p, ln_ffn, ffn)
        self.ln_cross = ln_cross
        self.cross = cross


class EncDecModel(nn.Module):
    def __init__(self, tok_embed, enc_layers, dec_layers, ln_enc, ln_dec,
                 lm_head):
        super().__init__()
        self.tok_embed = nn.Parameter(tok_embed, requires_grad=False)
        self.enc_layers = nn.ModuleList(enc_layers)
        self.dec_layers = nn.ModuleList(dec_layers)
        self.ln_enc = ln_enc
        self.ln_dec = ln_dec
        self.lm_head = nn.Parameter(lm_head, requires_grad=False)  # (d, V)


def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device=None) -> EncDecModel:
    """Random weights from `generator` (created on `device`), with the
    reference's scales."""
    dt = torch_dtype(cfg)
    kw = dict(generator=generator, dtype=dt, device=device)

    def norm():
        return norm_init(cfg.d_model, cfg.norm, dtype=dt, device=device)

    def attention():
        return attn.init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv,
                                   cfg.head_dim, **kw)

    def ffn():
        return dl.init_gelu_ffn(cfg.d_model, cfg.d_ff, **kw)

    enc = [EncLayer(norm(), attention(), norm(), ffn())
           for _ in range(cfg.enc_layers or cfg.n_layers)]
    dec = [DecLayer(norm(), attention(), norm(), ffn(), norm(), attention())
           for _ in range(cfg.n_layers)]
    lm_head = (torch.randn((cfg.d_model, cfg.vocab), generator=generator,
                           device=device) / math.sqrt(cfg.d_model)).to(dt)
    return EncDecModel(embed_init(cfg.vocab, cfg.d_model, **kw), enc, dec,
                       norm(), norm(), lm_head)


def init_dsg(model: EncDecModel, cfg: ModelConfig, *,
             generator: torch.Generator, device=None) -> Optional[dict]:
    if not cfg.dsg.enabled:
        return None
    k = dl.proj_dim(cfg.d_model, cfg.d_ff, cfg.dsg)
    r = projection.make_projection(k, cfg.d_model, generator=generator,
                                   dtype=torch_dtype(cfg), device=device)
    return refresh_dsg({"r": r}, model, cfg)


def refresh_dsg(dsg: Optional[dict], model: EncDecModel,
                cfg: ModelConfig) -> Optional[dict]:
    """f(W) = R @ w_up of every layer, from the current weights; R is
    kept.  Not differentiated."""
    if dsg is None:
        return None
    r = dsg["r"]
    with torch.no_grad():
        return {"r": r,
                "fw_enc": torch.stack([r @ l.ffn.w_up
                                       for l in model.enc_layers]),
                "fw_dec": torch.stack([r @ l.ffn.w_up
                                       for l in model.dec_layers])}


def _remat(cfg: ModelConfig, model: EncDecModel, cache) -> bool:
    """Recompute each layer in the backward: a training forward only."""
    return (cfg.remat and cache is None and torch.is_grad_enabled()
            and any(p.requires_grad for p in model.parameters()))


def _ffn(p, r, fw_l, x, cfg: ModelConfig):
    st = {"r": r, "fw": fw_l} if fw_l is not None else None
    return dl.gelu_ffn(p, x, st, cfg.dsg)


def _enc_layer(layer: EncLayer, x, cfg: ModelConfig, pos, r, fw_l):
    h = norm_apply(cfg.norm, layer.ln_attn, x)
    a, _ = attn.self_attention(layer.attn, h, n_heads=cfg.n_heads,
                               n_kv=cfg.n_kv, rope_theta=cfg.rope_theta,
                               q_pos=pos, causal=False, window=cfg.window,
                               shard=cfg.attn_shard)
    x = x + a
    h = norm_apply(cfg.norm, layer.ln_ffn, x)
    return x + _ffn(layer.ffn, r, fw_l, h, cfg)


def encode(model: EncDecModel, dsg: Optional[dict], cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S, d) stub embeddings -> encoder states (B, S, d)."""
    r = dsg["r"] if dsg else None
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames.to(torch_dtype(cfg))
    remat = _remat(cfg, model, None)
    for l, layer in enumerate(model.enc_layers):
        args = (layer, x, cfg, pos, r, dsg["fw_enc"][l] if dsg else None)
        x = (checkpoint(_enc_layer, *args, use_reentrant=False) if remat
             else _enc_layer(*args))
    return norm_apply(cfg.norm, model.ln_enc, x)


def _dec_layer(layer: DecLayer, x, cfg: ModelConfig, q_pos, cache_l, pos0,
               kv_pos, mem_k, mem_v, r, fw_l):
    h = norm_apply(cfg.norm, layer.ln_attn, x)
    a, _ = attn.self_attention(layer.attn, h, n_heads=cfg.n_heads,
                               n_kv=cfg.n_kv, rope_theta=cfg.rope_theta,
                               q_pos=q_pos, causal=True, window=0,
                               cache=cache_l, cache_pos=pos0,
                               cache_kv_pos=kv_pos, shard=cfg.attn_shard)
    x = x + a
    h = norm_apply(cfg.norm, layer.ln_cross, x)
    x = x + attn.cross_attention(layer.cross, h, mem_k, mem_v,
                                 n_heads=cfg.n_heads, q_pos=q_pos,
                                 shard=cfg.attn_shard)
    h = norm_apply(cfg.norm, layer.ln_ffn, x)
    return x + _ffn(layer.ffn, r, fw_l, h, cfg)


def decode(model: EncDecModel, dsg: Optional[dict], cfg: ModelConfig,
           tokens: torch.Tensor, memory_kv: dict, *,
           cache: Optional[dict] = None, pos0=0, last_only: bool = False):
    """Decoder pass: tokens (B, s) -> (logits, cache).  memory_kv {'k',
    'v'} (L, B, T, Kv, D), or lists of L (B, T, Kv, D): the encoder K/V
    of every decoder layer (`build_memory_kv`).  cache:
    the self-attention cache of Smax slots, written in place at positions
    pos0 (an int shared by the batch, as the reference's) onwards, the
    start clamped into [0, Smax - s] as the reference's
    dynamic_update_slice clamps it; the tokens attend over every slot,
    slot j holding position j, causally masked (as the reference's
    kv_pos = arange(Smax))."""
    if torch.is_tensor(pos0):
        if pos0.ndim:
            raise NotImplementedError(
                "the encoder-decoder decodes at one position shared by "
                "the batch, as the reference does")
        pos0 = int(pos0)
    r = dsg["r"] if dsg else None
    x = embed_tokens(model.tok_embed.to(torch_dtype(cfg)), tokens)
    q_pos = pos0 + torch.arange(x.shape[1], device=x.device)
    remat = _remat(cfg, model, cache)
    kv_pos = (None if cache is None
              else torch.arange(cache["k"].shape[2], device=x.device))
    for l, layer in enumerate(model.dec_layers):
        cache_l = (None if cache is None
                   else {"k": cache["k"][l], "v": cache["v"][l]})
        args = (layer, x, cfg, q_pos, cache_l, pos0, kv_pos,
                memory_kv["k"][l], memory_kv["v"][l], r,
                dsg["fw_dec"][l] if dsg else None)
        x = (checkpoint(_dec_layer, *args, use_reentrant=False) if remat
             else _dec_layer(*args))
    x = norm_apply(cfg.norm, model.ln_dec, x)
    if last_only:
        x = x[:, -1:]
    return x @ model.lm_head.to(x.dtype), cache


def build_memory_kv(model: EncDecModel, enc_states: torch.Tensor,
                    shard: str = "auto", stack: bool = True) -> dict:
    """Every decoder layer's cross K/V from the encoder states:
    {'k', 'v'} (L, B, T, Kv, D), the decode state's layout; with stack
    False, lists of each layer's (B, T, Kv, D), which a training forward
    takes (the backward of one layer's slice of a stack makes zeros of
    the whole stack)."""
    kv = [attn.memory_kv(l.cross, enc_states, shard)
          for l in model.dec_layers]
    ks, vs = [k for k, _ in kv], [v for _, v in kv]
    if not stack:
        return {"k": ks, "v": vs}
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def train_loss(model: EncDecModel, dsg: Optional[dict], cfg: ModelConfig,
               batch: dict, mesh=None, batch_axes=None) -> torch.Tensor:
    """Next-token loss of batch {'frames' (B, S, d), 'tokens', 'labels'
    (B, S // dec_ratio)}.  `mesh` and `batch_axes` are the reference's
    arguments, which its loss does not read either: the sharded run
    takes its layout from the parallel context."""
    enc = encode(model, dsg, cfg, batch["frames"])
    logits, _ = decode(model, dsg, cfg, batch["tokens"],
                       build_memory_kv(model, enc, cfg.attn_shard,
                                       stack=False))
    return sharded_cross_entropy(logits, batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, max_dec: int,
               dtype: torch.dtype, device=None) -> dict:
    shape = (cfg.n_layers, batch, max_dec, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.no_grad()
def prefill(model: EncDecModel, dsg, cfg: ModelConfig, frames, tokens,
            cache: dict):
    """Encoder pass, memory K/V and the decoder prompt into `cache`:
    (last_logits (B, V), {'self': cache, 'memory': memory K/V})."""
    if cache is None:
        raise ValueError("an encoder-decoder prefill needs the decoder "
                         "cache of api.make_cache")
    mem = build_memory_kv(model, encode(model, dsg, cfg, frames),
                          cfg.attn_shard)
    logits, cache = decode(model, dsg, cfg, tokens, mem, cache=cache,
                           pos0=0, last_only=True)
    return logits[:, -1], {"self": cache, "memory": mem}


@torch.no_grad()
def decode_step(model: EncDecModel, dsg, cfg: ModelConfig, token, state,
                pos):
    """One decode step: token (B, 1) at the shared position pos ->
    (logits (B, V), state)."""
    logits, cache = decode(model, dsg, cfg, token, state["memory"],
                           cache=state["self"], pos0=pos)
    return logits[:, -1], {"self": cache, "memory": state["memory"]}
