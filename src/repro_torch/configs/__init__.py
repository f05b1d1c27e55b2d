"""Model-zoo architecture configs: a copy of ``repro.configs``.

Each module registers one :class:`ArchConfig`; :func:`get_config` loads them
all on first use.
"""

import importlib

from repro_torch.configs.base import (
    INPUT_SHAPES,
    ArchConfig,
    InputShape,
    MLAConfig,
    MoEConfig,
    SSMConfig,
    all_configs,
    get_config,
    register,
)

__all__ = [
    "INPUT_SHAPES",
    "ArchConfig",
    "InputShape",
    "MLAConfig",
    "MoEConfig",
    "SSMConfig",
    "all_configs",
    "get_config",
    "load_all",
    "register",
]

_MODULES = [
    "gemma_7b",
    "phi4_mini_3_8b",
    "qwen1_5_32b",
    "qwen2_vl_72b",
    "zamba2_1_2b",
    "seamless_m4t_large_v2",
    "mamba2_370m",
    "llama3_405b",
    "granite_moe_3b_a800m",
    "deepseek_v2_236b",
]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
