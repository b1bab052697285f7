"""Architecture registry of the port: ``--arch <id>`` resolves here.

Every architecture of the JAX package's registry is registered; any
other name raises a ``KeyError``.  ``SHAPES`` / ``get_shape`` are the
assigned input shapes, as in the JAX package.
"""
from __future__ import annotations

from . import (dbrx_132b, deepseek_v2_236b, minicpm3_4b, musicgen_large,
               nemotron_4_15b, phi_3_vision_4_2b, qwen3_0_6b, qwen3_1_7b,
               rwkv6_7b, zamba2_2_7b)
from .base import (ByzantineConfig, InputShape, ModelConfig, RecoveryConfig,
                   TrainConfig)
from .shapes import SHAPES, get_shape

ARCHS = {
    "qwen3-0.6b": qwen3_0_6b.CONFIG,
    "qwen3-1.7b": qwen3_1_7b.CONFIG,
    "nemotron-4-15b": nemotron_4_15b.CONFIG,
    "minicpm3-4b": minicpm3_4b.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
    "dbrx-132b": dbrx_132b.CONFIG,
    "deepseek-v2-236b": deepseek_v2_236b.CONFIG,
    "zamba2-2.7b": zamba2_2_7b.CONFIG,
    "phi-3-vision-4.2b": phi_3_vision_4_2b.CONFIG,
    "musicgen-large": musicgen_large.CONFIG,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "ByzantineConfig", "InputShape", "ModelConfig",
           "RecoveryConfig", "TrainConfig", "get_config", "get_shape"]
