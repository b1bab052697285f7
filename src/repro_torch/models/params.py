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


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s dict structure holding ``leaves`` in leaf
    order (the inverse of :func:`tree_leaves`)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def tree_flatten(tree):
    """(leaves, rebuild) of a nested dict (sorted-key order) or a list:
    ``rebuild(new_leaves)`` gives the same structure back."""
    if isinstance(tree, dict):
        return tree_leaves(tree), lambda new: tree_unflatten(tree, new)
    return list(tree), list


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


# ---------------------------------------------------------------------------
# partition specs on a rank mesh
# ---------------------------------------------------------------------------
# A spec is a tuple with one entry a dimension: None (replicated), one mesh
# axis name, or a tuple of names (the JAX package's PartitionSpec entries).

# logical axis -> the mesh axis a leaf is tensor-sharded over
TENSOR_RULES = {
    "vocab": "model",
    "ff": "model",
    "heads": "model",
    "kv": "model",
    "experts": "model",
    "inner": "model",           # mamba2 d_inner
}


def _spec_for(d: ParamDef, mesh_shape: dict) -> tuple:
    """One leaf's spec: the first dimension whose logical axis maps to
    'model' and divides by the model axis's size."""
    n_model = mesh_shape.get("model", 1)
    entries: list = [None] * len(d.shape)
    for i, (s, a) in enumerate(zip(d.shape, d.axes)):
        if a is None or a in STACK_AXES or n_model <= 1:
            continue
        if TENSOR_RULES.get(a) == "model" and s % n_model == 0 \
                and s >= n_model:
            entries[i] = "model"
            break
    return tuple(entries)


def pspec_tree(defs, mesh, fsdp: bool = False):
    """The spec tree of a def-tree on ``mesh`` (anything with
    ``axis_names`` and ``shape``): each leaf tensor-sharded over 'model'
    where the JAX package's ``pspec_tree`` shards it.  ``fsdp=True`` waits
    for the blocked scope across ranks (ROADMAP A.4)."""
    if fsdp:
        raise NotImplementedError(
            "pspec_tree(fsdp=True) waits for the blocked scope across "
            "ranks (ROADMAP A.4)")
    mesh_shape = dict(zip(mesh.axis_names, mesh.shape))
    return tree_map_defs(lambda d: _spec_for(d, mesh_shape), defs)


def shard_view(shape, spec, mesh) -> tuple:
    """The slices of this rank's shard of a leaf of ``shape`` under
    ``spec`` (a dimension over axes of size n is cut into n equal parts,
    this rank's at its row-major index over them).  A replicated leaf's
    slices take everything."""
    slices = []
    for dim, s in enumerate(shape):
        entry = spec[dim] if spec is not None and dim < len(spec) else None
        if entry is None:
            slices.append(slice(None))
            continue
        n = mesh.size(entry)
        if s % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"divide over {entry} ({n})")
        part = s // n
        start = mesh.index(entry) * part
        slices.append(slice(start, start + part))
    return tuple(slices)
