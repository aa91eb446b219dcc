"""xlstm-350m [ssm] — 24L d_model=1024 4H vocab=50304, sLSTM + mLSTM
blocks (1 sLSTM per 4 layers), d_ff=0 (blocks carry their own up/down
projections).  [arXiv:2405.04517]

Recurrent (O(1)-state decode) -> runs the long_500k cell.
vocab padded 50304 (divisible by 128 and the 16-way model axis)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsg_linear import DSGConfig

ARCH_ID = "xlstm-350m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="xlstm", n_layers=24, d_model=1024,
        n_heads=4, n_kv=4, d_ff=0, vocab=50304, d_head=256,
        rope_theta=0.0, slstm_every=4, dtype="bfloat16",
        attn_bf16_scores=True,
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=128,
                      threshold_mode="shared", mode="mask", n_chunks=8),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=4, d_model=64, n_heads=2, n_kv=2, vocab=256, d_head=32,
        slstm_every=2, dtype="float32",
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=32,
                      threshold_mode="shared", mode="mask", n_chunks=1))
