"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the architectures whose blocks the port runs are registered; every
other name of the JAX package's registry raises a ``KeyError`` that
names the slice of ROADMAP.md that ports it.
"""
from __future__ import annotations

from . import qwen3_0_6b, rwkv6_7b
from .base import ByzantineConfig, ModelConfig, RecoveryConfig, TrainConfig

ARCHS = {
    "qwen3-0.6b": qwen3_0_6b.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
}

# the JAX package's other archs, by the block family that still has to be
# ported (ROADMAP.md A.3)
_DENSE = "the other dense zoo configs (ROADMAP A.3, after the train step)"
_LATER = {
    "qwen3-1.7b": _DENSE,
    "nemotron-4-15b": _DENSE,
    "phi-3-vision-4.2b": "the vision frontend (ROADMAP A.3)",
    "musicgen-large": "the audio frontend (ROADMAP A.3)",
    "minicpm3-4b": "MLA attention (ROADMAP A.3)",
    "deepseek-v2-236b": "MLA attention and MoE (ROADMAP A.3)",
    "dbrx-132b": "MoE (ROADMAP A.3)",
    "zamba2-2.7b": "mamba2 and the hybrid segment (ROADMAP A.3)",
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
