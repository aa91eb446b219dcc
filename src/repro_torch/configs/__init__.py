"""Architecture registry: --arch <id> resolves here.

Only internlm2-1.8b is ported so far; ROADMAP.md lists the other archs."""
from repro_torch.configs import internlm2_1_8b
from repro_torch.configs.base import ModelConfig

ARCHS = {m.ARCH_ID: m for m in (internlm2_1_8b,)}


def _arch(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ported: "
                       f"{sorted(ARCHS)}; see ROADMAP.md)")
    return ARCHS[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    return _arch(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _arch(arch_id).smoke_config()
