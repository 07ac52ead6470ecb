"""Assigned-architecture configs (``--arch <id>``).  All ten architectures
from the assignment, exact dims as specified; reduced smoke variants via
``get_config(name).reduced()``."""
from typing import Dict, List

from .base import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
                   LayerSpec, ModelConfig, ShapeSpec, shapes_for,
                   skipped_shapes_for)

from . import (gemma_2b, jamba_1_5_large_398b, kimi_k2_1t_a32b, mamba2_780m,
               minitron_4b, moonshot_v1_16b_a3b, pixtral_12b, qwen2_5_14b,
               tinyllama_1_1b, whisper_base)

_MODULES = [jamba_1_5_large_398b, whisper_base, kimi_k2_1t_a32b,
            moonshot_v1_16b_a3b, gemma_2b, qwen2_5_14b, minitron_4b,
            tinyllama_1_1b, pixtral_12b, mamba2_780m]

CONFIGS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(name: str) -> ModelConfig:
    import dataclasses
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(CONFIGS)}")
    return dataclasses.replace(CONFIGS[name])


def list_configs() -> List[str]:
    return [m.CONFIG.name for m in _MODULES]
