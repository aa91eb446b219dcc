"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (GQA kv=32, i.e. MHA)
d_ff=8192 vocab=32064.  RoPE SwiGLU.  [arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsg_linear import DSGConfig

ARCH_ID = "phi3-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", n_layers=32, d_model=3072,
        n_heads=32, n_kv=32, d_ff=8192, vocab=32064, d_head=96,
        rope_theta=10_000.0, dtype="bfloat16", attn_bf16_scores=True, microbatches=4,
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=128,
                      threshold_mode="shared", mode="mask", n_chunks=16),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=256, vocab=256,
        d_head=16, dtype="float32",
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=64,
                      threshold_mode="shared", mode="mask", n_chunks=1))
