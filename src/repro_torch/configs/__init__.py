"""Config registry: one module per assigned architecture.

``get_config(arch_id)`` returns the full-size ArchConfig;
``get_config(arch_id, reduced=True)`` the CPU smoke variant.
"""
from typing import Dict, List

from .base import ArchConfig, InputShape, MLAConfig, MoEConfig, SSMConfig, SHAPES

from .hymba_1_5b import CONFIG as _hymba
from .command_r_plus_104b import CONFIG as _command_r
from .phi35_moe_42b import CONFIG as _phi35
from .minicpm3_4b import CONFIG as _minicpm3
from .deepseek_v2_236b import CONFIG as _deepseek
from .gemma_7b import CONFIG as _gemma
from .llava_next_mistral_7b import CONFIG as _llava
from .seamless_m4t_medium import CONFIG as _seamless
from .mamba2_780m import CONFIG as _mamba2
from .qwen3_32b import CONFIG as _qwen3

REGISTRY: Dict[str, ArchConfig] = {
    c.arch_id: c
    for c in (
        _hymba, _command_r, _phi35, _minicpm3, _deepseek,
        _gemma, _llava, _seamless, _mamba2, _qwen3,
    )
}

ARCH_IDS: List[str] = sorted(REGISTRY)


def get_config(arch_id: str, reduced: bool = False) -> ArchConfig:
    cfg = REGISTRY[arch_id]
    return cfg.reduced() if reduced else cfg


__all__ = [
    "ArchConfig", "InputShape", "MLAConfig", "MoEConfig", "SSMConfig",
    "SHAPES", "REGISTRY", "ARCH_IDS", "get_config",
]
