"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + 1 shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E]

Simplifications (DESIGN.md §10): interleaved RoPE/NoPE layers -> RoPE
everywhere; 40 heads do not divide the model axis -> sequence-parallel
attention."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsg_linear import DSGConfig

ARCH_ID = "llama4-scout-17b-a16e"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe", n_layers=48, d_model=5120,
        n_heads=40, n_kv=8, d_ff=8192, vocab=202048, d_head=128,
        rope_theta=500_000.0, dtype="bfloat16", attn_bf16_scores=True, microbatches=4, moe_aux="probs",
        moe_experts=16, moe_topk=1, moe_shared=1, moe_d_ff=8192,
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=128,
                      threshold_mode="shared", mode="mask", n_chunks=16),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
        d_head=16, dtype="float32",
        moe_experts=4, moe_topk=1, moe_shared=1, moe_d_ff=128,
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=64,
                      threshold_mode="shared", mode="mask", n_chunks=1))
