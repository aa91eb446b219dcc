"""llama3.2-3b [dense] — 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256.  [hf:meta-llama/Llama-3.2-3B]

24 heads do not divide the 16-way model axis -> sequence-parallel
attention sharding (DESIGN.md §6)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsg_linear import DSGConfig

ARCH_ID = "llama3.2-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", n_layers=28, d_model=3072,
        n_heads=24, n_kv=8, d_ff=8192, vocab=128256, d_head=128,
        rope_theta=500_000.0, dtype="bfloat16", attn_bf16_scores=True, microbatches=2,
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=128,
                      threshold_mode="shared", mode="mask", n_chunks=16),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=256, vocab=256,
        d_head=16, dtype="float32",
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=64,
                      threshold_mode="shared", mode="mask", n_chunks=1))
