"""Architecture registry: --arch <id> resolves here.

Every arch of the reference is ported: the seven of the decoder families
(dense, moe, vlm), the two of the recurrent families (xlstm-350m, and the
zamba2-7b hybrid) and the encoder-decoder whisper-large-v3."""
from repro_torch.configs import (
    deepseek_moe_16b,
    internlm2_1_8b,
    llama3_2_3b,
    llama4_scout_17b_a16e,
    llava_next_34b,
    mistral_nemo_12b,
    phi3_mini_3_8b,
    whisper_large_v3,
    xlstm_350m,
    zamba2_7b,
)
from repro_torch.configs.base import (SHAPES, SMOKE_SHAPE,  # noqa: F401
                                      ModelConfig, ShapeConfig,
                                      shape_by_name)

_MODULES = (
    mistral_nemo_12b, internlm2_1_8b, llama3_2_3b, phi3_mini_3_8b,
    deepseek_moe_16b, llama4_scout_17b_a16e, xlstm_350m, llava_next_34b,
    whisper_large_v3, zamba2_7b,
)

ARCHS = {m.ARCH_ID: m for m in _MODULES}


def _arch(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r} (known: "
                       f"{sorted(ARCHS)})")
    return ARCHS[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return _arch(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _arch(arch_id).smoke_config()


# long_500k requires sub-quadratic attention: only the recurrent/hybrid
# archs run it; pure full-attention archs record a skip.
LONG_CONTEXT_ARCHS = ("xlstm-350m", "zamba2-7b")


def cell_is_runnable(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in LONG_CONTEXT_ARCHS
    return True
