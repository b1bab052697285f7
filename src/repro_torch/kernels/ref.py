"""Plain PyTorch versions of the aggregation kernels.

Each function is the port of the function of the same name in the JAX
package's ``kernels/ref.py``.  They are the oracles the CUDA kernels in
``csrc/brsgd_stats.cu`` are held against on the card, and the path
``ops`` takes for a tensor that lies on the CPU.  All operate on the
gradient matrix ``G`` of shape [m, d] (m workers, d dimensions) and run
on whichever device G lies on.

Determinism: ``column_mean_ref``/``masked_mean_det`` accumulate rows in
the fixed order 0, 1, …, m-1 and divide by a tensor on G's device, so
the division is IEEE division on every device (PyTorch's CUDA division
by a Python scalar multiplies by its reciprocal instead, ~1 ulp off).
"""
from __future__ import annotations

import functools
import math

import torch

# Canonical names of the additive per-leaf aggregation statistics, in the
# canonical emission order of the fused-stats pass.
STAT_NAMES = ("scores", "l1", "d2med", "gram")


# ---------------------------------------------------------------------------
# one-sort contract: the shared sorted-rows pass
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def bitonic_stages(n: int):
    """Compare-exchange index pairs for a bitonic sorting network of
    size n (a power of two): tuple of stages, each a tuple of
    (i, j, ascending) pairs.  The CUDA kernels run the same network."""
    stages = []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            pairs = []
            for i in range(n):
                l = i ^ j
                if l > i:
                    pairs.append((i, l, (i & k) == 0))
            stages.append(tuple(pairs))
            j //= 2
        k *= 2
    return tuple(stages)


def padded_workers(m: int) -> int:
    """The power of two the sorting network runs at (at least 2)."""
    return 1 << max(1, math.ceil(math.log2(m)))


def sorted_worker_rows(G):
    """Rows of G [m, d] sorted ascending per column — a list of m f32
    [d] tensors, via the static bitonic network, padded with +inf rows
    to a power of two (pad sorts last).  NaN propagates through each
    compare-exchange (torch.minimum/maximum), as in the JAX package."""
    x = G.to(torch.float32)
    m = x.shape[0]
    mp = padded_workers(m)
    rows = [x[i] for i in range(m)]
    rows += [torch.full_like(rows[0], math.inf)] * (mp - m)
    for stage in bitonic_stages(mp):
        for i, l, asc in stage:
            lo = torch.minimum(rows[i], rows[l])
            hi = torch.maximum(rows[i], rows[l])
            rows[i], rows[l] = (lo, hi) if asc else (hi, lo)
    return rows[:m]


def median_from_sorted(rows):
    """Coordinate-wise median from :func:`sorted_worker_rows` output
    (the two-middle average halves exactly)."""
    m = len(rows)
    if m % 2:
        return rows[m // 2]
    return 0.5 * (rows[m // 2 - 1] + rows[m // 2])


def det_sum_rows(G):
    """Sequential f32 row sum (axis 0) in row order 0..m-1 —
    bit-identical to NumPy's np.add.reduce(G, axis=0)."""
    s = torch.zeros_like(G[0])
    for r in G:
        s = s + r
    return s


def exact_div(x, den):
    """IEEE division by ``den`` held as a tensor on x's device."""
    return x / torch.as_tensor(den, dtype=torch.float32, device=x.device)


def column_mean_ref(G):
    Gf = G.to(torch.float32)
    return exact_div(det_sum_rows(Gf), float(Gf.shape[0]))


def cwise_median_ref(G):
    """Coordinate-wise median over the workers (rows) of G [m, d]."""
    return median_from_sorted(sorted_worker_rows(G))


def fused_stats_ref(G, needs) -> dict:
    """Any subset of :data:`STAT_NAMES` of G [m, d] from one shared
    sorted-rows pass: scores [m], l1 [m], d2med [m], gram [m, m].  The
    median is computed at most once and shared by l1 and d2med."""
    x = G.to(torch.float32)
    out = {}
    if "scores" in needs:
        out["scores"] = majority_score_ref(x)
    if "l1" in needs or "d2med" in needs:
        diff = x - median_from_sorted(sorted_worker_rows(x))[None]
        if "l1" in needs:
            out["l1"] = diff.abs().sum(dim=1)
        if "d2med" in needs:
            out["d2med"] = (diff * diff).sum(dim=1)
    if "gram" in needs:
        out["gram"] = x @ x.T
    return out


def majority_score_ref(G):
    """Paper Algorithm 2, Constraint-2 scores [m].  Per column: split
    workers by the column mean (row-order sum over m, IEEE-divided);
    workers on the larger side score 1, ties at exactly m/2 favour the
    >= mean side.  Score_i = sum over columns."""
    x = G.to(torch.float32)
    m = x.shape[0]
    mean_c = exact_div(det_sum_rows(x), float(m))
    above = x >= mean_c[None]
    n_above = above.to(torch.int32).sum(dim=0)
    majority_is_above = n_above * 2 >= m
    M = torch.where(majority_is_above[None], above, ~above)
    return M.to(torch.float32).sum(dim=1)


def l1_to_median_ref(G, med=None):
    if med is None:
        med = cwise_median_ref(G)
    return (G.to(torch.float32) - med[None]).abs().sum(dim=1)


def brsgd_stats_ref(G):
    """One fused pass: (median [d], mean [d], scores [m], l1 [m])."""
    med = cwise_median_ref(G)
    return (med, column_mean_ref(G), majority_score_ref(G),
            l1_to_median_ref(G, med))


def _guarded(sw):
    return torch.where(sw > 0, sw, torch.ones_like(sw))


def masked_mean_ref(G, mask):
    """Mean of the selected rows in matvec form.  mask: [m] bool/float;
    float weights give a weighted mean."""
    w = mask.to(torch.float32)
    return (w @ G.to(torch.float32)) / _guarded(w.sum())


def masked_mean_det(G, mask):
    """Weighted row mean with sequential accumulation in row order: a
    full mask is bit-identical to :func:`column_mean_ref`.  Rows of
    weight 0 are skipped with ``where``, never multiplied by 0, so a
    non-finite dropped row cannot leak into the result."""
    Gf = G.to(torch.float32)
    w = mask.to(torch.float32)
    s = torch.zeros_like(Gf[0])
    for i in range(Gf.shape[0]):
        s = torch.where(w[i] != 0, s + w[i] * Gf[i], s)
    return s / _guarded(w.sum())


def rank_select(x, k: int):
    """k-th smallest value of the 1-D vector x (0-indexed) by counting
    ranks: an element is the k-th order statistic iff
    (# strictly smaller) <= k < (# smaller-or-equal)."""
    lt = (x[None, :] < x[:, None]).to(torch.int32).sum(dim=1)
    le = (x[None, :] <= x[:, None]).to(torch.int32).sum(dim=1)
    hit = (lt <= k) & (k < le)
    return torch.where(hit, x, torch.full_like(x, -math.inf)).max()


def quantile_nearest_index(q: float, m: int) -> int:
    """Index of the ``method='nearest'`` q-quantile of a sorted m-vector;
    the virtual index q·(m-1) rounds half DOWN (jax's tie rule)."""
    virt = q * (m - 1)
    low = math.floor(virt)
    return low if (virt - low) <= 0.5 else low + 1


def brsgd_thresholds(scores, l1, beta: float, threshold: float):
    """Resolved C1/C2 cutoffs of paper Algorithm 2: (kth score, 𝔗),
    both counting quantiles; k = max(1, ⌈β·m⌉)."""
    m = scores.shape[0]
    k = max(1, math.ceil(beta * m))
    kth = rank_select(scores, m - k)
    if threshold > 0:
        T = torch.tensor(threshold, dtype=torch.float32, device=l1.device)
    else:
        T = rank_select(l1, quantile_nearest_index(0.25, m))
    return kth, T


def brsgd_masks(scores, l1, kth, T):
    """C1 = (ℓ1 ≤ 2𝔗), C2 = (score ≥ kth) and C1∩C2 with the empty-set
    fallback to C2, from resolved thresholds: (selected, c1, c2)."""
    c1 = l1 <= 2.0 * T
    c2 = scores >= kth
    sel = c1 & c2
    return torch.where(sel.any(), sel, c2), c1, c2


def brsgd_select_mask(scores, l1, beta: float, threshold: float):
    """C1∩C2 with the empty-set fallback to C2.
    Returns (selected, c1, c2, 𝔗) — all [m] bool except 𝔗."""
    kth, T = brsgd_thresholds(scores, l1, beta, threshold)
    return (*brsgd_masks(scores, l1, kth, T), T)


def trim_k(trim_frac: float, m: int) -> int:
    """Per-side trim count k = ⌊trim_frac·m⌋, guarded so at least one
    row survives."""
    k = int(trim_frac * m)
    if 2 * k >= m:
        k = (m - 1) // 2
    return k
