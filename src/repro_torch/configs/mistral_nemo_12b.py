"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx.  [hf:mistralai/Mistral-Nemo-Base-2407]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsg_linear import DSGConfig

ARCH_ID = "mistral-nemo-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", n_layers=40, d_model=5120,
        n_heads=32, n_kv=8, d_ff=14336, vocab=131072, d_head=128,
        rope_theta=1_000_000.0, dtype="bfloat16", attn_bf16_scores=True, microbatches=4,
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=128,
                      threshold_mode="shared", mode="mask", n_chunks=16),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=256, vocab=256,
        d_head=16, dtype="float32",
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=64,
                      threshold_mode="shared", mode="mask", n_chunks=1))
