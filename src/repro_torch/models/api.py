"""Model API used by the serving engine and the launcher (dense family).

  init_model(cfg, generator=, device=)          -> Transformer
  init_dsg(model, cfg, generator=, device=)     -> DSG state or None
  make_cache(cfg, batch, max_seq, device=)      -> dense {'k', 'v'} cache
  prefill(model, dsg, cfg, inputs, cache)       -> (last_logits, cache)
  decode_step(model, dsg, cfg, token, cache, pos) -> (logits, cache)

Serving picks the cache layout through `repro_torch.serving.kv_cache` and
passes the paged view into decode_step.  Caches are updated in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def init_model(cfg: ModelConfig, *, generator: torch.Generator, device=None):
    return transformer.init_model(cfg, generator=generator, device=device)


def init_dsg(model, cfg: ModelConfig, *, generator: torch.Generator,
             device=None) -> Optional[dict]:
    return transformer.init_dsg(model, cfg, generator=generator,
                                device=device)


def make_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> dict:
    return transformer.init_cache(cfg, batch, max_seq,
                                  dtype or transformer.torch_dtype(cfg),
                                  device)


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
