"""Parameter definitions and initialisation.

A model declares a dict of :class:`ParamDef` (shape + logical axes +
init).  Parameters are plain dicts of tensors in SORTED key order and in
the JAX package's layouts (HWIO convolutions, [in, out] dense), so a
flattened gradient lines up column for column with the JAX package's
``tree_to_vec`` and JAX parameters carry across as a plain copy.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

STACK_AXES = ("layers", "units", "sub")


class ParamDef(NamedTuple):
    shape: tuple
    axes: tuple                 # logical axis name (or None) per dim
    init: str = "normal"        # normal | zeros | ones
    scale: float = 1.0          # stddev multiplier for "normal"

    def __repr__(self):
        return f"ParamDef{self.shape}"


def _fan_in(d: ParamDef) -> int:
    if len(d.shape) == 1:
        return max(d.shape[0], 1)
    stack = int(np.prod([s for s, a in zip(d.shape, d.axes)
                         if a in STACK_AXES])) or 1
    return max(int(np.prod(d.shape[:-1])) // stack, 1)


def init_params(defs: dict, generator: torch.Generator, device="cpu",
                dtype=torch.float32) -> dict:
    """Materialise a def-dict: zeros/ones, or a fan-in scaled normal
    (std = scale / sqrt(fan_in)) drawn from ``generator`` leaf by leaf in
    sorted key order."""
    out = {}
    for name in sorted(defs):
        d = defs[name]
        if d.init == "zeros":
            out[name] = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            out[name] = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            std = d.scale / math.sqrt(_fan_in(d))
            x = torch.randn(d.shape, generator=generator,
                            dtype=torch.float32, device=device)
            out[name] = (x * std).to(dtype)
    return out


def params_from_jax(tree, device="cpu") -> dict:
    """Carry a JAX parameter dict (arrays or numpy arrays, JAX layouts)
    across as torch tensors on ``device``, in sorted key order."""
    return {k: torch.as_tensor(np.array(tree[k])).to(device)
            for k in sorted(tree)}
