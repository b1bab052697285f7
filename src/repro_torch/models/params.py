"""Parameter definitions and initialisation.

A model declares a def-tree: a dict, possibly nested, whose leaves are
:class:`ParamDef` (shape + logical axes + init).  Parameters are dicts
of the same structure holding tensors in the JAX package's layouts
(HWIO convolutions, [in, out] dense, ``[L, ...]`` stacked layers), with
keys walked in SORTED order as ``jax.tree`` walks them, so a flattened
gradient lines up column for column with the JAX package's
``tree_to_vec`` and JAX parameters carry across as a plain copy leaf by
leaf.
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


def tree_map_defs(fn, defs):
    """Apply ``fn`` to every ParamDef leaf of a (nested) def-tree; the
    result has the same dict structure, keys in sorted order."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: tree_map_defs(fn, defs[k]) for k in sorted(defs)}


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key depth-first order (the
    order ``jax.tree.leaves`` gives for the same dict)."""
    if not isinstance(tree, dict):
        return [tree]
    return [x for k in sorted(tree) for x in tree_leaves(tree[k])]


def count_params(defs) -> int:
    return int(sum(np.prod(d.shape) for d in tree_leaves(defs)))


def _init_one(d: ParamDef, generator, device, dtype):
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    std = d.scale / math.sqrt(_fan_in(d))
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)


def init_params(defs: dict, generator: torch.Generator, device="cpu",
                dtype=torch.float32) -> dict:
    """Materialise a (nested) def-tree: zeros/ones, or a fan-in scaled
    normal (std = scale / sqrt(fan_in), stack axes excluded from the
    fan-in) drawn from ``generator`` leaf by leaf in sorted key order.
    ``generator`` must live on ``device``."""
    return tree_map_defs(lambda d: _init_one(d, generator, device, dtype),
                         defs)


def params_from_jax(tree, device="cpu"):
    """Carry a JAX parameter tree (nested dicts of arrays or numpy
    arrays, JAX layouts) across as torch tensors on ``device``: the same
    keys, identity per leaf."""
    if isinstance(tree, dict):
        return {k: params_from_jax(tree[k], device) for k in sorted(tree)}
    return torch.as_tensor(np.array(tree)).to(device)
