"""Slot-paged decode cache for continuous batching (the port of the JAX
package's ``serving/cache.py``).

The whole serve fleet shares ONE cache tree shaped ``[max_batch]`` on
the batch axis.  A request's "page" is its batch slot: the
``BlockTable`` maps request-id → slot, and ``SlotCache.insert`` copies a
freshly-prefilled batch-1 cache slice into its slot in place.  The
buffers are allocated once and never move, so the decode step's CUDA
graph (``serving/scheduler.py``) sees the same addresses on every
replay, whatever the admissions and evictions.  Paging is
slot-granular: each slot owns a fixed ``max_len`` strip of every cache
leaf.

The batch axis position of every leaf comes from the logical axis names
in ``TF.cache_defs`` (``batch_axes``), not from hard-coded layouts: GQA's
``k`` / ``v``, MLA's latent ``c`` and rope key ``kr``, rwkv's state and
carries alike.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import transformer as TF


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _is_def(x) -> bool:
    return isinstance(x, tuple) and isinstance(x[0], tuple)


def batch_axes(cfg: ModelConfig, batch: int, seq_len: int):
    """Tree of ints: index of the 'batch' axis in every cache leaf."""
    def axes(defs):
        if _is_def(defs):
            return defs[1].index("batch")
        return {k: axes(v) for k, v in defs.items()}
    return axes(TF.cache_defs(cfg, batch, seq_len))


class BlockTable:
    """request-id → slot map over ``max_batch`` pages; O(1) alloc/free."""

    def __init__(self, max_batch: int):
        self.max_batch = max_batch
        self._free = list(range(max_batch - 1, -1, -1))
        self._slot_of: dict = {}

    def __len__(self):
        return len(self._slot_of)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def alloc(self, rid) -> int:
        if not self._free:
            raise RuntimeError("no free slots")
        slot = self._free.pop()
        self._slot_of[rid] = slot
        return slot

    def slot(self, rid) -> int:
        return self._slot_of[rid]

    def free(self, rid) -> int:
        slot = self._slot_of.pop(rid)
        self._free.append(slot)
        return slot


class SlotCache:
    """The shared ``[max_batch]`` cache buffers and the in-place slot
    insert."""

    def __init__(self, cfg: ModelConfig, max_batch: int, max_len: int,
                 dtype=torch.bfloat16, device="cpu"):
        self.cfg, self.max_batch, self.max_len = cfg, max_batch, max_len
        self.dtype = dtype
        self.bufs = TF.init_cache(cfg, max_batch, max_len, dtype, device)
        self.axes = batch_axes(cfg, max_batch, max_len)

    def insert(self, small, slot: int):
        """Copy a batch-1 cache slice (``TF.init_cache(cfg, 1, max_len)``
        filled by a prefill) into ``slot`` of every leaf, in place."""
        _map(lambda b, s, ax: b.narrow(ax, slot, 1).copy_(s),
             self.bufs, small, self.axes)
