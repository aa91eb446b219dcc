"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) vocab=102400,
MoE: 2 shared + 64 routed experts, top-6, fine-grained d_ff_e=1408.
[arXiv:2401.06066]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsg_linear import DSGConfig

ARCH_ID = "deepseek-moe-16b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe", n_layers=28, d_model=2048,
        n_heads=16, n_kv=16, d_ff=1408, vocab=102400, d_head=128,
        rope_theta=10_000.0, dtype="bfloat16", attn_bf16_scores=True, microbatches=2, moe_aux="probs",
        moe_experts=64, moe_topk=6, moe_shared=2, moe_d_ff=1408,
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=128,
                      threshold_mode="shared", mode="mask", n_chunks=16),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
        d_head=16, dtype="float32",
        moe_experts=4, moe_topk=2, moe_shared=1, moe_d_ff=128,
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=64,
                      threshold_mode="shared", mode="mask", n_chunks=1))
