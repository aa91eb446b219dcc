"""whisper-large-v3 [audio] — enc-dec, 32+32L d_model=1280 20H d_ff=5120
vocab=51866 (padded to 51872 for the 16-way model axis).
[arXiv:2212.04356]

Conv/mel frontend is a STUB: `api.make_inputs` provides frame embeddings
(B, S, d).  Decoder length = seq_len // dec_ratio.  RoPE replaces the
learned positional embeddings (the reference's documented
simplification)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsg_linear import DSGConfig

ARCH_ID = "whisper-large-v3"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="encdec", n_layers=32, enc_layers=32,
        d_model=1280, n_heads=20, n_kv=20, d_ff=5120, vocab=51872,
        d_head=64, rope_theta=10_000.0, act="gelu", norm="layernorm",
        dec_ratio=8, dtype="bfloat16", attn_bf16_scores=True,
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=128,
                      threshold_mode="shared", mode="mask", n_chunks=16,
                      score="abs_sum"),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv=4,
        d_ff=256, vocab=256, d_head=16, dec_ratio=4, dtype="float32",
        dsg=DSGConfig(enabled=True, gamma=0.5, eps=0.5, block=64,
                      threshold_mode="shared", mode="mask", n_chunks=1,
                      score="abs_sum"))
