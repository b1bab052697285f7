"""Flat-file checkpointing (the port of the JAX package's
``checkpoint/ckpt.py``), in the JAX package's on-disk format.

A save is one ``step_XXXXXXXX.npz`` holding every leaf of a nested dict
under its ``/``-joined key path (``seg_0/attn/wq``, keys walked in
sorted order as ``jax.tree`` walks a dict), plus a JSON manifest
``{"step", "keys", "extra"}`` (the port writes ``extra`` empty and
ignores it on restore).  bfloat16 leaves widen to float32 on save
(numpy has no bfloat16) and cast back to the target's dtype on restore.
So a checkpoint written by either package restores in the other.

Write protocol (the hot-swap watcher depends on it): every file lands
via temp-name + ``os.rename`` (atomic on POSIX), and the manifest is
written LAST.  ``latest_step`` only reports steps whose manifest exists,
so a reader polling the directory never observes a torn checkpoint:
either the step is invisible, or its ``.npz`` is complete.

Retention + last_good: ``save(..., keep=k)`` prunes all but the newest
``k`` complete steps — manifest removed FIRST (the step turns invisible
before its npz disappears) — and never the ``last_good`` step.  The
``last_good`` pointer only advances after :func:`validate` passes.

``restore(..., out=tree)`` copies into an existing tree in place (the
hot swapper's standby parameter slot): every member of the npz is read
and checked against the manifest and the target's keys and shapes
before the first copy, so a torn file never reaches a live buffer.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch


def _leaves_with_paths(tree, prefix=()):
    """[(path tuple, leaf)] of a nested dict, keys in sorted order
    (``jax.tree_util.tree_flatten_with_path``'s order for a dict)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_paths(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _keys(tree) -> list:
    return [_key(p) for p, _ in _leaves_with_paths(tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()           # lossless; restore casts back
        return t.cpu().numpy()
    a = np.asarray(leaf)
    if a.dtype.kind == "V":         # an ml_dtypes leaf (bfloat16 / fp8)
        a = a.astype(np.float32)
    return a


def _flatten_with_paths(tree) -> dict:
    return {_key(p): _to_numpy(leaf) for p, leaf in _leaves_with_paths(tree)}


def _atomic_write(path: str, write_fn):
    """Write via a temp name in the same directory, then rename."""
    tmp = path + ".tmp"
    write_fn(tmp)
    os.rename(tmp, path)


def tmp_npz(tmp: str):
    """np.savez appends '.npz' unless the name already ends with it —
    hand it an open file object so the temp name is used verbatim."""
    return open(tmp, "wb")


def _savez(tmp: str, arrays: dict):
    with tmp_npz(tmp) as f:
        np.savez(f, **arrays)


def _dump_json(tmp: str, obj):
    with open(tmp, "w") as f:
        json.dump(obj, f)


def _npz_path(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}.npz")


def save(path: str, tree, step: int = 0, keep: int = 0) -> str:
    """Atomically save ``tree`` (tensors on any device, or numpy arrays)
    as step ``step``; returns the npz path.  The ``.npz`` renames into
    place first, the manifest last.  ``keep`` > 0: afterwards prune all
    but the newest ``keep`` complete steps, sparing ``last_good``."""
    os.makedirs(path, exist_ok=True)
    arrays = _flatten_with_paths(tree)
    npz = _npz_path(path, step)
    _atomic_write(npz, lambda tmp: _savez(tmp, arrays))
    manifest = {"step": step, "keys": sorted(arrays), "extra": {}}
    _atomic_write(os.path.join(path, f"step_{step:08d}.json"),
                  lambda tmp: _dump_json(tmp, manifest))
    if keep > 0:
        prune(path, keep)
    return npz


def steps(path: str) -> list:
    """Sorted complete steps (both ``.npz`` and manifest present)."""
    if not os.path.isdir(path):
        return []
    files = set(os.listdir(path))
    return sorted(int(f[5:13]) for f in files
                  if f.startswith("step_") and f.endswith(".npz")
                  and f[:-4] + ".json" in files)


def latest_step(path: str) -> Optional[int]:
    """Newest step with BOTH the ``.npz`` and its manifest present."""
    all_steps = steps(path)
    return all_steps[-1] if all_steps else None


LAST_GOOD_FILE = "last_good.json"


def prune(path: str, keep: int) -> list:
    """Remove all but the newest ``keep`` complete steps, never the
    ``last_good`` step; the manifest goes first.  Returns the pruned
    steps."""
    good = last_good_step(path)
    victims = [s for s in steps(path)[:-keep] if s != good]
    for s in victims:
        for ext in (".json", ".npz"):
            try:
                os.remove(os.path.join(path, f"step_{s:08d}{ext}"))
            except FileNotFoundError:
                pass
    return victims


def _check_keys(step: int, saved: set, want: set, where: str = ""):
    if saved != want:
        raise ValueError(
            f"checkpoint step {step}{where} does not match the target "
            f"tree: missing={sorted(want - saved)} "
            f"extra={sorted(saved - want)}")


def _check_npz_keys(step: int, npz_keys: set, saved: set, suffix: str = ""):
    if npz_keys != saved:
        raise ValueError(
            f"checkpoint step {step}: manifest/npz disagree "
            f"(manifest-only={sorted(saved - npz_keys)} "
            f"npz-only={sorted(npz_keys - saved)}){suffix}")


def validate(path: str, step: int, like=None) -> None:
    """Raise unless checkpoint ``step`` would restore cleanly: the
    manifest parses, every member of the npz reads (a truncated npz
    fails here), the key sets agree, and — with ``like`` — they match
    the target tree."""
    saved = set(load_manifest(path, step)["keys"])
    with np.load(_npz_path(path, step)) as data:
        _check_npz_keys(step, set(data.files), saved)
        for k in data.files:
            data[k]                 # read every member: catches torn ones
    if like is not None:
        _check_keys(step, saved, set(_keys(like)))


def mark_good(path: str, step: int, like=None) -> None:
    """Advance the ``last_good`` pointer to ``step``, only after
    :func:`validate` passes."""
    validate(path, step, like=like)
    _atomic_write(os.path.join(path, LAST_GOOD_FILE),
                  lambda tmp: _dump_json(tmp, {"step": step}))


def last_good_step(path: str) -> Optional[int]:
    """The validated rollback anchor, or None (no pointer yet, or the
    pointed-at step has since vanished)."""
    try:
        with open(os.path.join(path, LAST_GOOD_FILE)) as f:
            step = json.load(f)["step"]
    except (OSError, json.JSONDecodeError, KeyError, TypeError):
        return None
    return step if step in steps(path) else None


def load_manifest(path: str, step: int) -> dict:
    with open(os.path.join(path, f"step_{step:08d}.json")) as f:
        return json.load(f)


def _torch_dtype(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(leaf).dtype)).dtype


def _leaf_device(leaf, device):
    if device is not None:
        return torch.device(device)
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
        return leaf.device
    return torch.device("cpu")


def restore(path: str, like, step: Optional[int] = None, device=None,
            out=None):
    """Restore step ``step`` (default: the newest complete one) into the
    structure of ``like``; returns (tree, step).

    The manifest's key set is checked against ``like`` before any array
    is read.  Then every member of the npz is read and its shape checked
    against ``like``'s leaf.  Only then: with ``out`` (a tree of the
    same structure) each leaf is copied into ``out`` in place and
    ``out`` is returned; without it, new tensors in ``like``'s dtypes on
    ``device`` (default: each leaf's own device, the CPU for numpy or
    meta leaves).  A failure anywhere raises before ``out`` is touched.
    """
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    manifest = load_manifest(path, step)
    flat = _leaves_with_paths(like)
    saved = set(manifest["keys"])
    _check_keys(step, saved, {_key(p) for p, _ in flat}, f" under {path}")
    arrays = []
    with np.load(_npz_path(path, step)) as data:
        _check_npz_keys(step, set(data.files), saved, " — torn write?")
        for p, leaf in flat:
            key = _key(p)
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                                 f"{tuple(leaf.shape)}")
            arrays.append(arr)
    if out is not None:
        dst = [leaf for _, leaf in _leaves_with_paths(out)]
        if [tuple(t.shape) for t in dst] != [a.shape for a in arrays]:
            raise ValueError("out does not have like's leaves and shapes")
        for t, arr in zip(dst, arrays):
            t.copy_(torch.from_numpy(arr))
        return out, step
    leaves = iter(torch.from_numpy(arr).to(dtype=_torch_dtype(leaf),
                                           device=_leaf_device(leaf, device))
                  for arr, (_, leaf) in zip(arrays, flat))
    return _rebuild(like, leaves), step


def empty_like(like, device):
    """A new tree of uninitialised tensors with ``like``'s structure,
    shapes and dtypes on ``device`` (``like`` may hold tensors on any
    device, ``meta`` included, or numpy arrays)."""
    return _rebuild(like, iter(
        torch.empty(tuple(leaf.shape), dtype=_torch_dtype(leaf),
                    device=device)
        for _, leaf in _leaves_with_paths(like)))


def _rebuild(like, leaves):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    return next(leaves)
