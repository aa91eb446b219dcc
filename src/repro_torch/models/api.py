"""Model API used by the serving engine, the launchers and the tests: every
family of `repro.models.api`, the decoder ones (dense, moe, vlm), the
recurrent ones (xlstm, zamba) and the encoder-decoder one (encdec).

  init_model(cfg, generator=, device=)          -> the family's nn.Module
  init_dsg(model, cfg, generator=, device=)     -> DSG state or None
  refresh_dsg(dsg, model, cfg)                  -> DSG state, f(W) anew
  train_loss(model, dsg, cfg, batch, mesh=, batch_axes=) -> scalar loss
  make_cache(cfg, batch, max_seq, device=)      -> decode state (None for
                                                   xlstm, built lazily;
                                                   max_seq // dec_ratio
                                                   decoder slots for
                                                   encdec)
  prefill(model, dsg, cfg, inputs, cache)       -> (last_logits, state)
  decode_step(model, dsg, cfg, token, state, pos) -> (logits, state)
  make_inputs(cfg, shape, concrete=, seed=, device=) -> batch dict

Serving picks a decoder's cache layout through `repro_torch.serving.kv_cache`
and passes the paged view into decode_step; decoder caches are updated in
place.  The recurrent families return new states, as the reference's do
(`models/recurrent.py`), and take neither DRS score collection nor the
group-CSR FFN; nor does the encoder-decoder family, whose prefill takes
{'frames', 'tokens'} and returns the state {'self': the decoder cache,
'memory': the encoder K/V}.  The entry points that make tensors put them
on the card unless the caller asks for the CPU (`device="cpu"`); with no
card they raise.

Sharded (the decoder and encoder-decoder families): `train_loss`,
`prefill`, `decode_step` and `prefill_slot` take the reference's `mesh`
and `batch_axes`, for a model whose weights are DTensors on that mesh
(`parallel.sharding.distribute_model`).  The call runs under the mesh's
parallel context, installed here unless the caller has; a backward of a
sharded loss runs under it too (`parallel.context.use_mesh`).  The
recurrent families' verbs take no `mesh`, as the reference's: called on
DTensor weights, state and inputs under the caller's parallel context,
they run sharded by those layouts (`models/recurrent.py`).
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, recurrent, transformer
from repro_torch.parallel import context as pctx

DECODER_FAMILIES = transformer.DECODER_FAMILIES
RECURRENT_FAMILIES = ("xlstm", "zamba")
FAMILIES = DECODER_FAMILIES + RECURRENT_FAMILIES + ("encdec",)


def require_device(device) -> torch.device:
    """`device` as a torch.device; raise if it names CUDA and there is no
    card, rather than carry on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


def _require_family(cfg: ModelConfig, verb: str) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{verb}: unknown family {cfg.family!r} (the "
                         f"families are {FAMILIES})")


def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device="cuda"):
    _require_family(cfg, "init_model")
    device = require_device(device)
    if cfg.family == "encdec":
        return encdec.init_model(cfg, generator=generator, device=device)
    if cfg.family == "xlstm":
        return recurrent.init_xlstm_model(cfg, generator=generator,
                                          device=device)
    if cfg.family == "zamba":
        return recurrent.init_zamba_model(cfg, generator=generator,
                                          device=device)
    return transformer.init_model(cfg, generator=generator, device=device)


def init_dsg(model, cfg: ModelConfig, *, generator: torch.Generator,
             device="cuda") -> Optional[dict]:
    _require_family(cfg, "init_dsg")
    device = require_device(device)
    if cfg.family == "encdec":
        return encdec.init_dsg(model, cfg, generator=generator,
                               device=device)
    if cfg.family == "xlstm":
        return recurrent.init_xlstm_dsg(model, cfg, generator=generator,
                                        device=device)
    if cfg.family == "zamba":
        return recurrent.init_zamba_dsg(model, cfg, generator=generator,
                                        device=device)
    return transformer.init_dsg(model, cfg, generator=generator,
                                device=device)


def refresh_dsg(dsg: Optional[dict], model, cfg: ModelConfig):
    _require_family(cfg, "refresh_dsg")
    if cfg.family == "encdec":
        return encdec.refresh_dsg(dsg, model, cfg)
    if cfg.family == "xlstm":
        return recurrent.refresh_xlstm_dsg(dsg, model, cfg)
    if cfg.family == "zamba":
        return recurrent.refresh_zamba_dsg(dsg, model, cfg)
    return transformer.refresh_dsg(dsg, model, cfg)


def _mesh_ctx(cfg: ModelConfig, mesh):
    """The parallel context of `mesh` unless it is installed already; a
    recurrent family takes no mesh."""
    if mesh is None:
        return nullcontext()
    if cfg.family in RECURRENT_FAMILIES:
        raise TypeError(f"family {cfg.family!r} takes no mesh, as in the "
                        f"reference: lay its weights, state and inputs out "
                        f"as DTensors and call it under the mesh's "
                        f"parallel context")
    ctx = pctx.current()
    if ctx is not None and ctx.mesh is mesh:
        return nullcontext()
    return pctx.use_mesh(mesh)


def train_loss(model, dsg, cfg: ModelConfig, batch: dict, mesh=None,
               batch_axes=None) -> torch.Tensor:
    _require_family(cfg, "train_loss")
    with _mesh_ctx(cfg, mesh):
        return _train_loss(model, dsg, cfg, batch, mesh, batch_axes)


def _train_loss(model, dsg, cfg: ModelConfig, batch: dict, mesh,
                batch_axes) -> torch.Tensor:
    if cfg.family == "encdec":
        return encdec.train_loss(model, dsg, cfg, batch, mesh, batch_axes)
    if cfg.family == "xlstm":
        logits, _ = recurrent.xlstm_forward(model, dsg, cfg, batch["tokens"])
        return transformer.sharded_cross_entropy(logits, batch["labels"])
    if cfg.family == "zamba":
        logits, _ = recurrent.zamba_forward(model, dsg, cfg, batch["tokens"])
        return transformer.sharded_cross_entropy(logits, batch["labels"])
    return transformer.train_loss(model, dsg, cfg, batch, mesh, batch_axes)


def make_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda"):
    _require_family(cfg, "make_cache")
    dt = dtype or transformer.torch_dtype(cfg)
    device = require_device(device)
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, max_seq // cfg.dec_ratio, dt,
                                 device)
    if cfg.family == "xlstm":
        return None          # the state is built inside xlstm_forward
    if cfg.family == "zamba":
        return recurrent.init_zamba_cache(cfg, batch, max_seq, dt, device)
    return transformer.init_cache(cfg, batch, max_seq, dt, device)


def _refuse_serving_features(cfg: ModelConfig, what: str) -> None:
    raise NotImplementedError(
        f"{what} are decoder-family serving features (family "
        f"{cfg.family!r})")


@torch.no_grad()
def prefill(model, dsg, cfg: ModelConfig, inputs: dict, cache,
            mesh=None, batch_axes=None, collect_drs_scores: bool = False):
    """The prompt's last logits (B, V) and the decode state.  A zamba
    prefill ignores `cache`, as the reference's does: its K/V come back
    with the prompt's length, which decode then uses as a ring.  An
    encoder-decoder prefill takes inputs {'frames', 'tokens'}."""
    _require_family(cfg, "prefill")
    with _mesh_ctx(cfg, mesh):
        return _prefill(model, dsg, cfg, inputs, cache, mesh, batch_axes,
                        collect_drs_scores)


def _prefill(model, dsg, cfg: ModelConfig, inputs: dict, cache, mesh,
             batch_axes, collect_drs_scores: bool):
    if cfg.family in DECODER_FAMILIES:
        return transformer.prefill(model, dsg, cfg, inputs["tokens"], cache,
                                   prefix_embeds=inputs.get("prefix_embeds"),
                                   collect_drs_scores=collect_drs_scores,
                                   mesh=mesh, batch_axes=batch_axes)
    if collect_drs_scores:
        _refuse_serving_features(cfg, "DRS score collection")
    if cfg.family == "encdec":
        return encdec.prefill(model, dsg, cfg, inputs["frames"],
                              inputs["tokens"], cache)
    if cfg.family == "xlstm":
        logits, st = recurrent.xlstm_forward(model, dsg, cfg,
                                             inputs["tokens"], last_only=True)
    else:
        logits, st = recurrent.zamba_forward(model, dsg, cfg,
                                             inputs["tokens"], state=None,
                                             last_only=True)
    return logits[:, -1], st


@torch.no_grad()
def decode_step(model, dsg, cfg: ModelConfig, token, cache, pos,
                live_pages=None, mesh=None, batch_axes=None, ffn_csr=None,
                collect_drs_scores: bool = False):
    _require_family(cfg, "decode_step")
    with _mesh_ctx(cfg, mesh):
        return _decode_step(model, dsg, cfg, token, cache, pos, live_pages,
                            mesh, batch_axes, ffn_csr, collect_drs_scores)


def _decode_step(model, dsg, cfg: ModelConfig, token, cache, pos,
                 live_pages, mesh, batch_axes, ffn_csr,
                 collect_drs_scores: bool):
    if cfg.family in DECODER_FAMILIES:
        return transformer.decode_step(model, dsg, cfg, token, cache, pos,
                                       live_pages=live_pages,
                                       ffn_csr=ffn_csr,
                                       collect_drs_scores=collect_drs_scores,
                                       mesh=mesh, batch_axes=batch_axes)
    if ffn_csr is not None or collect_drs_scores:
        _refuse_serving_features(
            cfg, "group-CSR decode / DRS score collection")
    if cfg.family == "encdec":
        return encdec.decode_step(model, dsg, cfg, token, cache, pos)
    if cfg.family == "xlstm":
        logits, st = recurrent.xlstm_forward(model, dsg, cfg, token,
                                             state=cache)
    else:
        logits, st = recurrent.zamba_forward(model, dsg, cfg, token,
                                             state=cache, pos0=pos)
    return logits[:, -1], st


# ---------------------------------------------------------------------------
# per-slot cache surgery: deprecated thin wrappers, as in the reference.
# The engine drives `serving.kv_cache` backends instead; these take raw
# dense cache dicts whose leaves carry the batch on axis 1 (L, B, ...).
# ---------------------------------------------------------------------------

def make_slot_cache(cfg: ModelConfig, max_seq: int, dtype=None,
                    device="cuda"):
    """Deprecated: a 1-lane dense cache for solo prompt prefill, the same
    as ``make_cache(cfg, 1, max_seq)``."""
    return make_cache(cfg, 1, max_seq, dtype, device=device)


def prefill_slot(model, dsg, cfg: ModelConfig, tokens, lane_cache,
                 mesh=None, batch_axes=None):
    """Deprecated: prefill one prompt lane, tokens (1, P) -> (last_logits
    (1, V), the filled 1-lane cache); ``prefill`` with a {"tokens": ...}
    batch."""
    return prefill(model, dsg, cfg, {"tokens": tokens}, lane_cache,
                   mesh=mesh, batch_axes=batch_axes)


def merge_slot_cache(cache, lane_cache, slot):
    """Deprecated: copy a 1-lane cache into lane `slot` of a batched dense
    cache, in place (`serving.kv_cache.dense_merge`), and return it."""
    from repro_torch.serving.kv_cache import dense_merge
    dense_merge(cache, lane_cache, slot)
    return cache


# ---------------------------------------------------------------------------
# input construction
# ---------------------------------------------------------------------------

def make_inputs(cfg: ModelConfig, shape: ShapeConfig, *,
                concrete: bool = False, seed: int = 0,
                device="cuda") -> dict:
    """The batch dict for a shape cell, as the reference's: kind 'train'
    {'tokens', 'labels'}, 'prefill' {'tokens'}, 'decode' {'token'}; a VLM
    adds 'prefix_embeds' (B, P, d) to train and prefill, with P =
    min(vision_prefix, max(seq_len // 4, 1)) cut from the text; an
    encoder-decoder takes 'frames' (B, seq_len, d) and tokens of
    max(1, seq_len // dec_ratio).  With
    `concrete` the arrays are the reference's: int32 tokens from
    np.random.default_rng(seed) and standard-normal embeddings from
    default_rng(seed + 1), each array drawn from a fresh generator; else
    shape-only tensors on the meta device."""
    _require_family(cfg, "make_inputs")
    b, s = shape.global_batch, shape.seq_len
    dt = transformer.torch_dtype(cfg)
    device = require_device(device) if concrete else torch.device("meta")

    def tok(shp):
        if concrete:
            rng = np.random.default_rng(seed)
            return torch.from_numpy(rng.integers(
                0, cfg.vocab, shp, dtype=np.int32)).to(device)
        return torch.empty(shp, dtype=torch.int32, device=device)

    def emb(shp):
        if concrete:
            rng = np.random.default_rng(seed + 1)
            return torch.from_numpy(rng.standard_normal(shp)).to(
                device=device, dtype=dt)
        return torch.empty(shp, dtype=dt, device=device)

    if cfg.family == "encdec":
        sd = max(1, s // cfg.dec_ratio)
        if shape.kind == "train":
            return {"frames": emb((b, s, cfg.d_model)),
                    "tokens": tok((b, sd)), "labels": tok((b, sd))}
        if shape.kind == "prefill":
            return {"frames": emb((b, s, cfg.d_model)), "tokens": tok((b, sd))}
        return {"token": tok((b, 1))}
    if cfg.family == "vlm":
        p = min(cfg.vision_prefix, max(s // 4, 1))
        st = s - p
        if shape.kind == "train":
            return {"prefix_embeds": emb((b, p, cfg.d_model)),
                    "tokens": tok((b, st)), "labels": tok((b, st))}
        if shape.kind == "prefill":
            return {"prefix_embeds": emb((b, p, cfg.d_model)),
                    "tokens": tok((b, st))}
        return {"token": tok((b, 1))}
    if shape.kind == "train":
        return {"tokens": tok((b, s)), "labels": tok((b, s))}
    if shape.kind == "prefill":
        return {"tokens": tok((b, s))}
    return {"token": tok((b, 1))}
