"""Kernel dispatch by the tensor's device.

A CUDA tensor goes to the hand-written kernel (:mod:`.brsgd_stats`,
:mod:`.flash_attention`, :mod:`.wkv6`), which launches or raises; a CPU
tensor goes to the plain version (:mod:`.ref`), which autograd
differentiates.  There is no flag that sends a CUDA tensor to the plain
version, and no fallback when a build or launch fails.

Attention and the WKV6 scan take their ``torch.autograd.Function``
(forward kernel + hand-written backward kernel) only when grad mode is
on and an input requires grad; otherwise, as in serving and under
``torch.no_grad()``, the single forward launch that writes nothing for
a backward.

The elastic ``valid=`` calls are the exception by design, as in the JAX
package, which has no Pallas kernel for masked statistics and takes its
jnp reference for them on the TPU too: a masked ``fused_stats``,
``cwise_median`` or ``trimmed_mean`` runs the masked torch functions of
:mod:`.ref` on whichever device G lies on.  The masked combine still
goes through the masked-mean kernel (``engine.aggregate_local``).  A
fused masked kernel is optional later work.
"""
from __future__ import annotations

import torch

from . import brsgd_stats as kern
from . import flash_attention as fa_kern
from . import ref
from . import wkv6 as wkv_kern

_COUNTERS = (kern.LAUNCHES, fa_kern.LAUNCHES, wkv_kern.LAUNCHES)
_COPY_COUNTERS = (fa_kern.COPIES, wkv_kern.COPIES)


def launches() -> dict:
    """Launches of every kernel since the last :func:`reset_launches`
    (a copy: {kernel name: count})."""
    return {k: n for c in _COUNTERS for k, n in c.items()}


def copies() -> dict:
    """Gradient inputs the backward kernels had to copy to a layout they
    read, since the last :func:`reset_launches` ({name: count})."""
    return {k: n for c in _COPY_COUNTERS for k, n in c.items()}


def reset_launches() -> None:
    for c in _COUNTERS + _COPY_COUNTERS:
        for k in c:
            c[k] = 0


def _canonical(needs) -> tuple:
    return tuple(n for n in ref.STAT_NAMES if n in needs)


def fused_stats(G, needs, valid=None, rows=None, refs=None,
                scores_dtype=torch.float32) -> dict:
    """Any subset of ``ref.STAT_NAMES`` from one read of G [m, d].

    ``valid`` ([m] 0/1) switches to the masked pass over the active
    workers; ``rows``/``refs`` are the streaming-accumulator hooks (one
    arrival bucket's output slots, shared active-set invariants).
    ``scores_dtype`` (unmasked pass) is the type the exact score counts
    are rounded to once: double keeps them exact past 2^24 columns."""
    needs = _canonical(needs)
    if not needs:
        return {}
    if valid is not None:
        return ref.masked_fused_stats_ref(G, needs, valid, rows=rows,
                                          refs=refs)
    if G.is_cuda:
        return kern.fused_stats(G, needs, scores_dtype)
    return ref.fused_stats_ref(G, needs, scores_dtype)


def masked_stat_refs(G, needs, valid) -> dict:
    """Shared active-set invariants for the streaming accumulator
    (``ref.masked_stat_refs``), computed once per G."""
    return ref.masked_stat_refs(G, _canonical(needs), valid)


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


def brsgd_aggregate(G, beta: float, threshold: float) -> ref.BrSGDAggregate:
    """Local BrSGD from G [m, d] to the aggregate and its diagnostics
    (``ref.BrSGDAggregate``): on the card one cooperative launch that
    resolves the thresholds itself, on the CPU the plain composition."""
    if G.is_cuda:
        return kern.brsgd_aggregate(G, beta, threshold)
    return ref.brsgd_aggregate_plain(G, beta, threshold)


def select_aggregate(G, rule: str, n_close: int = 1, k: int = 0,
                     iters: int = 1, eps: float = 1e-6) -> ref.SelectAggregate:
    """A select rule (mean, krum, multi_krum, geomedian) over all of G
    [m, d] to the aggregate and its diagnostics (``ref.SelectAggregate``):
    on the card one launch (the cooperative kernel; B3 alone for the
    mean), on the CPU the plain composition."""
    if G.is_cuda:
        return kern.select_aggregate(G, rule, n_close, k, iters, eps)
    return ref.select_aggregate_plain(G, rule, n_close, k, iters, eps)


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


def cwise_median(G, valid=None):
    """Coordinate-wise median [d]; over the active rows with ``valid``."""
    if valid is not None:
        return ref.masked_cwise_median_ref(G, valid)
    if G.is_cuda:
        return kern.cwise_median(G)
    return ref.cwise_median_ref(G)


def trimmed_mean(G, trim_frac: float, valid=None):
    """Coordinate-wise trimmed mean [d], k = ``ref.trim_k(trim_frac, m)``
    per side; with ``valid`` both counts are over the active rows."""
    if valid is not None:
        return ref.masked_trimmed_mean_ref(G, trim_frac, valid)
    if G.is_cuda:
        return kern.trimmed_mean(G, trim_frac)
    return ref.trimmed_mean_ref(G, trim_frac)


def _training(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v, window: int = 0):
    """q [B,H,S,D], k/v [B,Hkv,T,D] -> [B,H,S,D]: causal (sliding-window
    when window > 0) GQA softmax attention (B6 on the card)."""
    if q.is_cuda:
        if _training(q, k, v):
            return fa_kern.FlashAttentionFn.apply(q, k, v, window)
        return fa_kern.flash_attention(q, k, v, window)
    return ref.flash_attention_ref(q, k, v, window)


def wkv6_seq(r, k, v, w, u, S_in, chunk: int):
    """The chunked WKV6 scan of one layer, r/k/v/w [B,S,H,K] in chunks of
    min(chunk, S) tokens -> (y [B,S,H,K], S_final [B,H,K,K]) (B7 on the
    card, one launch)."""
    if r.is_cuda:
        if _training(r, k, v, w, u, S_in):
            return wkv_kern.WKV6SeqFn.apply(r, k, v, w, u, S_in, chunk)
        return wkv_kern.wkv6_seq(r, k, v, w, u, S_in, chunk)
    return ref.wkv6_seq_plain(r, k, v, w, u, S_in, chunk)


def wkv6_chunk(r, k, v, w, u, S_in):
    """One RWKV-6 chunk, r/k/v/w [B,H,Q,K] -> (y [B,H,Q,K], S_out
    [B,H,K,K]) (B7's one-chunk call on the card)."""
    if r.is_cuda:
        return wkv_kern.wkv6_chunk(r, k, v, w, u, S_in)
    return ref.wkv6_chunk_plain(r, k, v, w, u, S_in)
