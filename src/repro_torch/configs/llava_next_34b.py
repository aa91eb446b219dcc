"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, anyres tiling.  [hf:llava-hf/llava-v1.6-34b-hf]

The vision tower is a STUB per the assignment: input_specs provides
precomputed patch embeddings (B, P, d_model) prepended to the text
sequence.  56 heads do not divide the model axis -> sequence-parallel
attention.  Pure full attention -> long_500k cell skipped."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsg_linear import DSGConfig

ARCH_ID = "llava-next-34b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm", n_layers=60, d_model=7168,
        n_heads=56, n_kv=8, d_ff=20480, vocab=64000, d_head=128,
        rope_theta=5_000_000.0, vision_prefix=2880, dtype="bfloat16", attn_bf16_scores=True, microbatches=4,
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=128,
                      threshold_mode="shared", mode="mask", n_chunks=16),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=256, vocab=256,
        d_head=16, vision_prefix=8, dtype="float32",
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=64,
                      threshold_mode="shared", mode="mask", n_chunks=1))
