"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544.  [arXiv:2403.17297]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsg_linear import DSGConfig

ARCH_ID = "internlm2-1.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", n_layers=24, d_model=2048,
        n_heads=16, n_kv=8, d_ff=8192, vocab=92544, d_head=128,
        rope_theta=1_000_000.0, dtype="bfloat16", attn_bf16_scores=True, microbatches=2,
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=128,
                      threshold_mode="shared", mode="mask", n_chunks=16),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=256, vocab=256,
        d_head=16, dtype="float32",
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=64,
                      threshold_mode="shared", mode="mask", n_chunks=1))
