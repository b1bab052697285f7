"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the architectures whose blocks the port runs are registered; every
other name of the JAX package's registry raises a ``KeyError`` that
names the slice of ROADMAP.md that ports it.
"""
from __future__ import annotations

from . import (dbrx_132b, deepseek_v2_236b, minicpm3_4b, nemotron_4_15b,
               qwen3_0_6b, qwen3_1_7b, rwkv6_7b)
from .base import ByzantineConfig, ModelConfig, RecoveryConfig, TrainConfig

ARCHS = {
    "qwen3-0.6b": qwen3_0_6b.CONFIG,
    "qwen3-1.7b": qwen3_1_7b.CONFIG,
    "nemotron-4-15b": nemotron_4_15b.CONFIG,
    "minicpm3-4b": minicpm3_4b.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
    "dbrx-132b": dbrx_132b.CONFIG,
    "deepseek-v2-236b": deepseek_v2_236b.CONFIG,
}

# the JAX package's other archs, by what they still need (ROADMAP.md A.3)
_LATER = {
    "zamba2-2.7b": "mamba2 and the hybrid segment (ROADMAP A.3)",
    "phi-3-vision-4.2b": "the vision frontend and B6's head dim 96 "
                         "(ROADMAP A.3)",
    "musicgen-large": "the audio frontend (ROADMAP A.3)",
}


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in _LATER:
        raise KeyError(f"arch {name!r} is not ported yet: it waits for "
                       f"{_LATER[name]}; ported: {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; ported: {sorted(ARCHS)}")


__all__ = ["ARCHS", "ByzantineConfig", "ModelConfig", "RecoveryConfig",
           "TrainConfig", "get_config"]
