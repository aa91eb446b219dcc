"""Model config schema (the port's copy of `repro.configs.base.ModelConfig`).

Every field of the reference is kept so a config compares field for field
with its JAX counterpart.  The port runs every family: the decoder ones
(dense, moe, vlm), the recurrent ones (xlstm, zamba) and the
encoder-decoder one (encdec).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

from repro_torch.core.dsg_linear import DSGConfig


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | xlstm | zamba | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 -> d_model // n_heads
    rope_theta: float = 1_000_000.0
    act: str = "swiglu"         # swiglu | gelu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    tie_embeddings: bool = False
    # --- MoE ---
    moe_experts: int = 0
    moe_topk: int = 0
    moe_shared: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_heads: int = 0
    ssm_chunk: int = 128
    shared_attn_every: int = 0
    slstm_every: int = 0
    # --- encoder-decoder ---
    enc_layers: int = 0
    dec_ratio: int = 8
    # --- VLM ---
    vision_prefix: int = 0
    # --- attention ---
    window: int = 0             # sliding-window size (0 = full)
    attn_shard: str = "auto"
    # --- DSG ---
    dsg: DSGConfig = field(default_factory=DSGConfig)
    # --- numerics / execution ---
    dtype: str = "float32"      # activation/param dtype: float32 | bfloat16
    remat: bool = True
    max_seq: int = 8192
    branch_constrain: bool = False
    moe_aux: str = "topk"
    seq_sharded_residual: bool = False
    gqa_native: bool = False
    attn_bf16_scores: bool = False   # prefill QK^T scores and probabilities
                                     # kept bf16 (softmax stats stay f32)
    paged_attn_kernel: str = "auto"  # paged decode: "auto" (the kernel for
                                     # CUDA tensors, its plain version for
                                     # CPU tensors) or "kernel" (CUDA only)
    dsg_ffn_apply: str = "auto"      # group-CSR FFN: "auto" or "kernel",
                                     # as paged_attn_kernel
    microbatches: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


# Smoke-test shape used by per-arch CPU smoke tests.
SMOKE_SHAPE = ShapeConfig("smoke", 32, 2, "train")
