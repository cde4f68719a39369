"""Registry of the 10 assigned architectures (``--arch <id>``)."""

from repro_torch.configs import (chameleon_34b, deepseek_v2_lite_16b, gemma3_1b,
                           mamba2_13b, olmoe_1b_7b, qwen15_4b, stablelm_12b,
                           stablelm_3b, whisper_large_v3, zamba2_27b)
from repro_torch.configs.base import SHAPES, ModelConfig

_MODULES = {
    "whisper-large-v3": whisper_large_v3,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "stablelm-3b": stablelm_3b,
    "qwen1.5-4b": qwen15_4b,
    "stablelm-12b": stablelm_12b,
    "gemma3-1b": gemma3_1b,
    "mamba2-1.3b": mamba2_13b,
    "chameleon-34b": chameleon_34b,
    "zamba2-2.7b": zamba2_27b,
}

ARCHS = tuple(_MODULES)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    mod = _MODULES[name]
    return mod.REDUCED if reduced else mod.CONFIG


def all_configs(reduced: bool = False):
    return {name: get_config(name, reduced) for name in ARCHS}
