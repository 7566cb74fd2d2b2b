"""Model configurations of the port (a copy of the JAX package's
framework-free ``repro.configs`` modules it needs): the VGG family and
``get_config(arch_id)`` for the transformer architectures ported so
far."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    ATTN_KINDS, INPUT_SHAPES, LAYER_KINDS, EncoderConfig, FrontendConfig,
    InputShape, MLAConfig, MoEConfig, ModelConfig, SSMConfig,
    active_param_count, param_count, reduced)

# the architectures whose model path the port runs; the others come with
# their slices (ROADMAP.md queue 1, items 2-3)
ARCH_IDS = ("glm4-9b", "gemma3-27b", "gemma-7b", "command-r-plus-104b",
            "mixtral-8x7b", "deepseek-v2-236b", "recurrentgemma-9b",
            "xlstm-125m")

_MODULES: Dict[str, str] = {a: a.replace("-", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch_id!r}; "
                       f"known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg
