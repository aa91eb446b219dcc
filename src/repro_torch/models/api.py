"""Model API used by the serving engine and the launcher (dense family).

  init_model(cfg, generator=, device=)          -> Transformer
  init_dsg(model, cfg, generator=, device=)     -> DSG state or None
  refresh_dsg(dsg, model, cfg)                  -> DSG state, f(W) anew
  train_loss(model, dsg, cfg, batch)            -> scalar loss
  make_cache(cfg, batch, max_seq, device=)      -> dense {'k', 'v'} cache
  prefill(model, dsg, cfg, inputs, cache)       -> (last_logits, cache)
  decode_step(model, dsg, cfg, token, cache, pos) -> (logits, cache)

Serving picks the cache layout through `repro_torch.serving.kv_cache` and
passes the paged view into decode_step.  Caches are updated in place.
The entry points that make tensors put them on the card unless the caller
asks for the CPU (`device="cpu"`); with no card they raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def require_device(device) -> torch.device:
    """`device` as a torch.device; raise if it names CUDA and there is no
    card, rather than carry on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device="cuda"):
    return transformer.init_model(cfg, generator=generator,
                                  device=require_device(device))


def init_dsg(model, cfg: ModelConfig, *, generator: torch.Generator,
             device="cuda") -> Optional[dict]:
    return transformer.init_dsg(model, cfg, generator=generator,
                                device=require_device(device))


def _require_dense(cfg: ModelConfig, verb: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{verb} for the {cfg.family!r} family is not ported (the port "
            f"runs the dense family; ROADMAP.md queue 1 item 8)")


def refresh_dsg(dsg: Optional[dict], model, cfg: ModelConfig):
    _require_dense(cfg, "refresh_dsg")
    return transformer.refresh_dsg(dsg, model, cfg)


def train_loss(model, dsg, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    _require_dense(cfg, "train_loss")
    return transformer.train_loss(model, dsg, cfg, batch)


def make_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> dict:
    return transformer.init_cache(cfg, batch, max_seq,
                                  dtype or transformer.torch_dtype(cfg),
                                  require_device(device))


def prefill(model, dsg, cfg: ModelConfig, inputs: dict, cache,
            collect_drs_scores: bool = False):
    return transformer.prefill(model, dsg, cfg, inputs["tokens"], cache,
                               collect_drs_scores=collect_drs_scores)


def decode_step(model, dsg, cfg: ModelConfig, token, cache, pos,
                live_pages=None, ffn_csr=None,
                collect_drs_scores: bool = False):
    return transformer.decode_step(model, dsg, cfg, token, cache, pos,
                                   live_pages=live_pages, ffn_csr=ffn_csr,
                                   collect_drs_scores=collect_drs_scores)
