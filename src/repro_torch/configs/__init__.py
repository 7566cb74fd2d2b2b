"""Model configurations of the port (a copy of the JAX package's
framework-free ``repro.configs`` modules): the VGG family and
``get_config(arch_id)`` for every transformer architecture of the JAX
package."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    ATTN_KINDS, INPUT_SHAPES, LAYER_KINDS, EncoderConfig, FrontendConfig,
    InputShape, MLAConfig, MoEConfig, ModelConfig, SSMConfig,
    active_param_count, param_count, reduced)

# every architecture of the JAX package's registry, in its order
ARCH_IDS = ("gemma3-27b", "glm4-9b", "mixtral-8x7b", "xlstm-125m",
            "command-r-plus-104b", "deepseek-v2-236b", "gemma-7b",
            "recurrentgemma-9b", "whisper-small", "internvl2-1b")

_MODULES: Dict[str, str] = {a: a.replace("-", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg
