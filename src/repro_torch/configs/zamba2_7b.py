"""zamba2-7b [hybrid] — Mamba2 backbone + ONE weight-shared attention+FFN
block applied every 6 Mamba blocks.  d_model=3584 32H (kv=32) d_ff=14336
vocab=32000 ssm_state=64.  [arXiv:2411.15242]

81 assigned layers realized as 78 Mamba2 blocks (13 groups x 6) + 13
invocations of the shared block, as the reference realizes them.  Shared
attention uses a 4096 sliding window so the hybrid stays sub-quadratic ->
runs long_500k."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsg_linear import DSGConfig

ARCH_ID = "zamba2-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="zamba", n_layers=78, d_model=3584,
        n_heads=32, n_kv=32, d_ff=14336, vocab=32000, d_head=112,
        rope_theta=10_000.0, window=4096, dtype="bfloat16", attn_bf16_scores=True, microbatches=4,
        ssm_state=64, ssm_expand=2, ssm_heads=112, ssm_chunk=128,
        shared_attn_every=6,
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=128,
                      threshold_mode="shared", mode="mask", n_chunks=16),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv=4, d_ff=256, vocab=256,
        d_head=16, window=16, dtype="float32",
        ssm_state=16, ssm_expand=2, ssm_heads=4, ssm_chunk=16,
        shared_attn_every=2,
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=32,
                      threshold_mode="shared", mode="mask", n_chunks=1))
