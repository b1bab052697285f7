"""Kernel dispatch by the tensor's device.

A CUDA tensor goes to the hand-written kernel (:mod:`.brsgd_stats`),
which launches or raises; a CPU tensor goes to the plain version
(:mod:`.ref`).  There is no flag that sends a CUDA tensor to the plain
version, and no fallback when a build or launch fails.
"""
from __future__ import annotations

from . import brsgd_stats as kern
from . import ref


def fused_stats(G, needs) -> dict:
    """Any subset of ``ref.STAT_NAMES`` from one read of G [m, d]."""
    needs = tuple(n for n in ref.STAT_NAMES if n in needs)
    if not needs:
        return {}
    if G.is_cuda:
        return kern.fused_stats(G, needs)
    return ref.fused_stats_ref(G, needs)


def brsgd_partials(G):
    """G [m, d] -> (scores [m], l1 [m]) — pass 1 of local BrSGD."""
    st = fused_stats(G, ("scores", "l1"))
    return st["scores"], st["l1"]


def brsgd_select_mean(G, scores, l1, kth, T):
    """C1∩C2 selection + masked mean (pass 2 of local BrSGD) from the
    thresholds (kth, 𝔗) of ``ref.brsgd_thresholds``.
    Returns (aggregate [d], selection weights [m])."""
    if G.is_cuda:
        return kern.select_mean(G, scores, l1, kth, T)
    sel, _, _ = ref.brsgd_masks(scores, l1, kth, T)
    w = sel.float()
    return ref.masked_mean_det(G, w), w


def masked_mean(G, mask):
    """Masked (bool) or weighted (f32) row mean Σ w_i g_i / Σ w_i in row
    order (``ref.masked_mean_det`` on the CPU)."""
    if G.is_cuda:
        return kern.masked_mean(G, mask)
    return ref.masked_mean_det(G, mask)


def brsgd_stats(G):
    """G [m, d] -> (median [d], mean [d], scores [m], l1 [m])."""
    if G.is_cuda:
        return kern.brsgd_stats(G)
    return ref.brsgd_stats_ref(G)


def cwise_median(G):
    if G.is_cuda:
        return kern.cwise_median(G)
    return ref.cwise_median_ref(G)
