"""Architecture registry: --arch <id> resolves here.

The seven archs of the decoder families (dense, moe, vlm) and the two of
the recurrent families (xlstm-350m, and the zamba2-7b hybrid) are ported;
the encoder-decoder arch whisper-large-v3 is not yet (ROADMAP.md queue 1
item 8)."""
from repro_torch.configs import (
    deepseek_moe_16b,
    internlm2_1_8b,
    llama3_2_3b,
    llama4_scout_17b_a16e,
    llava_next_34b,
    mistral_nemo_12b,
    phi3_mini_3_8b,
    xlstm_350m,
    zamba2_7b,
)
from repro_torch.configs.base import (SHAPES, SMOKE_SHAPE,  # noqa: F401
                                      ModelConfig, ShapeConfig,
                                      shape_by_name)

_MODULES = (
    mistral_nemo_12b, internlm2_1_8b, llama3_2_3b, phi3_mini_3_8b,
    deepseek_moe_16b, llama4_scout_17b_a16e, llava_next_34b, xlstm_350m,
    zamba2_7b,
)

ARCHS = {m.ARCH_ID: m for m in _MODULES}


def _arch(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ported: "
                       f"{sorted(ARCHS)}; see ROADMAP.md queue 1 item 8)")
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
