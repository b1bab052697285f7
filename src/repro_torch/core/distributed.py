"""Distributed robust aggregation over a rank mesh: the thin
collective-facing wrapper over :mod:`.engine` (the twin of the JAX
package's ``core/distributed.py``).

Every registered aggregator runs in either layout of
``engine.aggregate_sharded``: ``gather`` (each leaf all-gathered to
[m, cols] on every rank, the paper's "master collects G") or ``a2a``
(each leaf all_to_all'd so a rank holds every worker for 1/m of the
columns; 1x transient memory).  Both give the same aggregate up to
float32 summation order.  Fault injection across ranks is
``threat.inject``.
"""
from __future__ import annotations

from ..configs.base import ByzantineConfig
from . import engine


def robust_aggregate(grads, cfg: ByzantineConfig, mesh, axes=("data",),
                     layout: str = "gather", model_axes=(), leaf_specs=None,
                     valid=None, plan=None):
    """Aggregate this rank's gradient tree across the worker axes of
    ``mesh``: (the aggregate, the same on every worker with its model
    shards intact; the selection diagnostics: BrSGDState for brsgd,
    SelectionState for the other select rules, None for the column
    rules and the mean's fast path).  ``model_axes`` / ``leaf_specs``
    declare tensor-sharded leaves; ``valid`` ([m] 0/1) runs the elastic
    round; ``plan`` is the per-leaf layouts of ``layout="auto"``.  See
    ``engine.aggregate_sharded``."""
    return engine.aggregate_sharded(grads, cfg, mesh, axes=axes,
                                    layout=layout, model_axes=model_axes,
                                    leaf_specs=leaf_specs, valid=valid,
                                    plan=plan)
