"""Blocked (streaming) robust aggregation on one device: every rule
registered in :mod:`.engine` runs per *bucket* inside the backward.

Port of the JAX package's ``core/blocked.py``.  A bucket is one layer
slice of a segment (one unit slice of a hybrid segment, its 6 mamba2
blocks), or the top-level rest: embed, final_norm, lm_head and
shared_attn.  Every statistic in the registry adds up over disjoint
column ranges, so a rule runs per bucket with a bucket-local selection,
the moment the bucket's gradients have all come in, and the worker
gradients of the whole model, G [m, D], never exist.  The selection is
per bucket instead of global: a deviation from the paper, as in the
reference (DESIGN.md §2).

The reference runs one worker per device and gets the layers' lockstep
from SPMD.  Here one device simulates all m workers, and the lockstep
comes from the graph: the workers run layer-major
(``models.transformer.loss_fn_workers``), and torch's autograd engine
runs the ready node of the highest sequence number first, so the
backward takes the buckets one after the other, every worker's gradient
of a layer before any of the layer below.

The barrier of one bucket is two ``torch.autograd.Function``\\ s:

* a gate, once a bucket: its forward returns aliases of the bucket's
  parameters (which do not require grad) and takes the bucket's
  selection token, which does, so the graph runs through it;
* a tap, once a worker and use site: its forward returns that worker's
  view of the aliases; its backward adds the worker's gradient into
  the worker's row of the bucket's [m, d_b] buffer as it arrives (the
  buffer is made at the first arrival) and hands nothing on.

The gate's backward runs once every tap of its bucket has: it corrupts
the byzantine rows in place (``threat.apply_dense_`` under the step's
one membership, with noise from :func:`bucket_generator`), aggregates
them (:func:`aggregate_rows`: on the card one kernel launch for a fixed
round), writes the aggregate into the step's aggregate leaves, frees
the buffer and returns the one-hot of the bucket's n_selected as the
token's gradient.  Taps per use site keep the top bucket's rows the only
copy of its gradient: the head's gradient lands in them at the start of
the backward, the embedding lookup's at its end (a tied embedding sums
both in one row), and a hybrid model's shared block adds each unit's.
So at any moment the backward holds the top bucket's rows and those of
the one layer being filled.

There is no FSDP gather (the reference's ``make_fsdp_agg_barrier``
forward): one device holds every parameter, so the barrier is
:func:`make_agg_barrier`, and the reference's a2a padding and its
``pad_correction`` have no counterpart, since no column is padded.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from ..configs.base import ByzantineConfig
from ..models import params as PM
from . import engine, threat


def bucket_key(seed: int, name: str, layer: int = 0) -> int:
    """The attack-noise seed of one bucket call: the step's seed, the
    bucket name's crc32 (so the id survives a reordering of the bucket
    set) and the layer index folded together, as the reference's
    ``bucket_key`` and the barrier's ``fold_in(…, layer_idx)`` do.  Noise
    differs across buckets and across the layers of one segment;
    membership is drawn once a step instead (``threat.step_membership``)."""
    tag = zlib.crc32(name.encode()) & 0x7FFFFFFF
    return int(np.random.SeedSequence(
        [int(seed), tag, int(layer)]).generate_state(1)[0])


def bucket_generator(seed: int, name: str, layer: int, device):
    """A ``torch.Generator`` on ``device`` seeded with :func:`bucket_key`."""
    return torch.Generator(device=device).manual_seed(
        bucket_key(seed, name, layer))


def selection_token(m: int, device) -> torch.Tensor:
    """Zero token fed to a bucket's gate.  Its gradient is the one-hot
    histogram of the bucket's n_selected (length m+1, index = count),
    summed over the gate calls that share it (a segment's layers)."""
    return torch.zeros((m + 1,), dtype=torch.float32, device=device,
                       requires_grad=True)


def aggregate_rows(rows, bcfg: ByzantineConfig, valid=None):
    """One bucket's worker-major rows [m, d_b] -> (aggregate [d_b],
    ``engine.SelectionState``-like state with ``selected``).

    A fixed round is ``engine.aggregate_local`` (one launch on the card
    for every rule); an elastic one (``valid`` [m] 0/1) the masked round
    over the active rows, which zeroes the inactive rows of ``rows`` in
    place first.  A column rule selects every (active) worker."""
    m = rows.shape[0]
    if valid is not None:
        return engine.aggregate_local(rows, bcfg, return_state=True,
                                      valid=valid, inplace=True)
    agg, st = engine.aggregate_local(rows, bcfg, return_state=True)
    if st is None:
        ones = torch.ones((m,), dtype=torch.float32, device=rows.device)
        st = engine.SelectionState(ones > 0, ones)
    return agg, st


def _bucket_aggregate(g, bcfg: ByzantineConfig, valid=None):
    """Aggregate one bucket of per-worker gradients (a tree of [m, ...]
    leaves) with any registered rule: the leaves flattened into one
    worker-major [m, d_b] in tree order, then :func:`aggregate_rows`.
    One selection over the concatenated leaves is the reference's per-leaf
    partials, summed, then one selection.  Returns (the aggregate as a
    tree of the leaves' shapes without the worker axis, the state)."""
    leaves = PM.tree_leaves(g)
    m = leaves[0].shape[0]
    rows = torch.cat([x.reshape(m, -1).to(torch.float32) for x in leaves],
                     dim=1)
    agg, st = aggregate_rows(rows, bcfg, valid)
    out, a = [], 0
    for x in leaves:
        n = x[0].numel()
        out.append(agg[a:a + n].view(x.shape[1:]).to(x.dtype))
        a += n
    it = iter(out)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(g), st


class BlockedRound:
    """What the buckets of one step share: the config, the m slots, the
    workers that take a gradient (``workers``, slot ids in the order
    ``loss_fn_workers`` runs them), the step's seed (noise), its byzantine
    membership (drawn once) and, in an elastic round, the validity mask.

    ``calls`` records one (bucket, layer, n_selected tensor) a gate, and
    ``live`` / ``peak_live`` the buckets whose rows exist: the lockstep
    the layer-major backward gives."""

    def __init__(self, bcfg: ByzantineConfig, m: int, workers, seed: int,
                 membership=None, valid=None):
        self.bcfg, self.m, self.workers = bcfg, m, list(workers)
        self.seed, self.membership, self.valid = seed, membership, valid
        self.calls = []
        self.live = set()
        self.peak_live = set()

    def _alive(self, key, on: bool):
        if on:
            self.live.add(key)
            if len(self.live) > len(self.peak_live):
                self.peak_live = set(self.live)
        else:
            self.live.discard(key)


class _Bucket:
    """One bucket call: its parameter leaves (tree order), their offsets
    in a row, the aggregate's destinations, and the rows once made."""

    def __init__(self, rnd: BlockedRound, name: str, layer: int, leaves,
                 out):
        self.rnd, self.name, self.layer = rnd, name, layer
        self.shapes = [tuple(x.shape) for x in leaves]
        sizes = [x.numel() for x in leaves]
        self.offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        self.out = out
        self.device = leaves[0].device
        self.rows = None

    def arrive(self, slot: int, k: int, g):
        """Add one worker's gradient of leaf ``k`` into its row."""
        if self.rows is None:
            self.rows = torch.zeros((self.rnd.m, self.offs[-1]),
                                    dtype=torch.float32, device=self.device)
            self.rnd._alive((self.name, self.layer), True)
        a, b = self.offs[k], self.offs[k + 1]
        self.rows[slot, a:b].view(self.shapes[k]).add_(g)

    def finish(self):
        """Inject, aggregate, write the aggregate out and free the rows;
        the one-hot of n_selected [m+1]."""
        rnd, m = self.rnd, self.rnd.m
        rows = self.rows
        if rows is None:
            rows = torch.zeros((m, self.offs[-1]), dtype=torch.float32,
                               device=self.device)
        self.rows = None
        gen = bucket_generator(rnd.seed, self.name, self.layer, self.device)
        threat.apply_dense_(rows, gen, rnd.bcfg, active=rnd.valid,
                            membership=rnd.membership)
        agg, st = aggregate_rows(rows, rnd.bcfg, rnd.valid)
        for k, dst in enumerate(self.out):
            dst.copy_(agg[self.offs[k]:self.offs[k + 1]].view(
                self.shapes[k]))
        del rows, agg
        rnd._alive((self.name, self.layer), False)
        n_sel = st.selected.to(torch.int64).sum()
        rnd.calls.append((self.name, self.layer, n_sel))
        return torch.nn.functional.one_hot(n_sel, m + 1).to(torch.float32)


class _Gate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bucket, tok, *leaves):
        ctx.bucket = bucket
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(ctx, *grads):
        hist = ctx.bucket.finish()
        return (None, hist) + (None,) * len(grads)


class _Tap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bucket, slot, idx, *q):
        ctx.bucket, ctx.slot, ctx.idx = bucket, slot, idx
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in q)

    @staticmethod
    def backward(ctx, *grads):
        for k, g in zip(ctx.idx, grads):
            if g is not None:
                ctx.bucket.arrive(ctx.slot, k, g)
        return (None, None, None) + (None,) * len(grads)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        prefix + (k,))]
    return [prefix]


def _build(paths, values):
    out: dict = {}
    for path, v in zip(paths, values):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


class BucketViews:
    """The gated aliases of one bucket call."""

    def __init__(self, bucket: _Bucket, paths, aliases):
        self.bucket, self.paths, self.aliases = bucket, paths, aliases

    def workers(self, keys=None) -> list:
        """A tap for every running worker, in the round's worker order:
        its view of the bucket (of the top-level keys in ``keys`` only,
        the part one use site reads)."""
        idx = tuple(k for k, p in enumerate(self.paths)
                    if keys is None or p[0] in keys)
        paths = [self.paths[k] for k in idx]
        return [_build(paths, _Tap.apply(self.bucket, slot, idx,
                                         *(self.aliases[k] for k in idx)))
                for slot in self.bucket.rnd.workers]


def make_agg_barrier(rnd: BlockedRound, name: str):
    """The aggregation barrier of bucket ``name`` in round ``rnd``:
    ``barrier(p_bucket, tok, layer_idx, out) -> BucketViews``, with
    ``p_bucket`` the bucket's parameters (a tree of tensors that do not
    require grad), ``tok`` its :func:`selection_token`, ``layer_idx`` the
    position in the segment (folded into the noise) and ``out`` the
    aggregate's destination leaves in tree order.  The reference's
    ``make_fsdp_agg_barrier`` also gathers FSDP shards in its forward;
    one device holds every parameter, so here the forward only hands out
    views."""
    def barrier(p_bucket, tok, layer_idx: int, out) -> BucketViews:
        paths = _paths(p_bucket)
        leaves = PM.tree_leaves(p_bucket)
        bucket = _Bucket(rnd, name, int(layer_idx), leaves, list(out))
        aliases = _Gate.apply(bucket, tok, *leaves)
        return BucketViews(bucket, paths, aliases)
    return barrier
