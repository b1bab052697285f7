"""Plain PyTorch versions of the kernels.

The aggregation functions port the functions of the same name in the
JAX package's ``kernels/ref.py``; the attention and WKV6 functions at
the end port the oracles of ``kernels/flash_attention.py`` and
``kernels/wkv6.py``.  They are the oracles the CUDA kernels in
``csrc/`` are held against on the card, and the path ``ops`` takes for
a tensor that lies on the CPU.  The masked (elastic)
functions have no kernel, as in the JAX package: ``ops`` runs them on
either device.  The aggregation functions operate on the gradient
matrix ``G`` of shape [m, d] (m workers, d dimensions); every function
runs on whichever device its inputs lie on.

Determinism: ``column_mean_ref``/``masked_mean_det`` accumulate rows in
the fixed order 0, 1, …, m-1 and divide by a tensor on G's device, so
the division is IEEE division on every device (PyTorch's CUDA division
by a Python scalar multiplies by its reciprocal instead, ~1 ulp off).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

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


def sorted_worker_stack(x):
    """G [m, d] sorted ascending per column as an [m, d] f32 tensor, via
    the static bitonic network of :func:`bitonic_stages`, padded with
    +inf rows to a power of two (pad sorts last).  Each stage is one
    gather, min, max and select over the stacked rows; NaN propagates
    through each compare-exchange (torch.minimum/maximum), as in the JAX
    package.  The CUDA kernels run the same network."""
    x = x.to(torch.float32)
    m = x.shape[0]
    mp = padded_workers(m)
    if mp > m:
        pad = torch.full((mp - m,) + tuple(x.shape[1:]), math.inf,
                         dtype=torch.float32, device=x.device)
        x = torch.cat([x, pad])
    for perm, keep_lo in _stage_tables(mp, x.device):
        partner = x[perm]
        x = torch.where(keep_lo, torch.minimum(x, partner),
                        torch.maximum(x, partner))
    return x[:m]


@functools.lru_cache(maxsize=None)
def _stage_tables(mp: int, device: torch.device):
    """Per stage of the size-mp network: each slot's partner [mp] and
    whether it keeps the smaller value [mp, 1], held on ``device``."""
    tables = []
    for stage in bitonic_stages(mp):
        perm = list(range(mp))
        keep_lo = [False] * mp
        for i, l, asc in stage:
            perm[i], perm[l] = l, i
            keep_lo[i], keep_lo[l] = asc, not asc
        tables.append((torch.tensor(perm, device=device),
                       torch.tensor(keep_lo, device=device)[:, None]))
    return tuple(tables)


def sorted_worker_rows(G):
    """:func:`sorted_worker_stack` as a list of m f32 [d] rows."""
    return list(sorted_worker_stack(G))


def median_from_sorted(rows):
    """Coordinate-wise median from :func:`sorted_worker_stack` output
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
    return median_from_sorted(sorted_worker_stack(G))


def fused_stats_ref(G, needs, scores_dtype=torch.float32) -> dict:
    """Any subset of :data:`STAT_NAMES` of G [m, d] from one shared
    sorted-rows pass: scores [m], l1 [m], d2med [m], gram [m, m].  The
    median is computed at most once and shared by l1 and d2med."""
    x = G.to(torch.float32)
    out = {}
    if "scores" in needs:
        out["scores"] = majority_score_ref(x, scores_dtype)
    if "l1" in needs or "d2med" in needs:
        diff = x - median_from_sorted(sorted_worker_stack(x))[None]
        if "l1" in needs:
            out["l1"] = diff.abs().sum(dim=1)
        if "d2med" in needs:
            out["d2med"] = (diff * diff).sum(dim=1)
    if "gram" in needs:
        out["gram"] = x @ x.T
    return out


def majority_score_ref(G, dtype=torch.float32):
    """Paper Algorithm 2, Constraint-2 scores [m].  Per column: split
    workers by the column mean (row-order sum over m, IEEE-divided);
    workers on the larger side score 1, ties at exactly m/2 favour the
    >= mean side.  Score_i = sum over columns, counted in integers and
    rounded once to ``dtype`` (a float is exact up to 2^24 columns, as the
    kernels' counts are; below, the float sum's bits)."""
    x = G.to(torch.float32)
    m = x.shape[0]
    mean_c = exact_div(det_sum_rows(x), float(m))
    above = x >= mean_c[None]
    n_above = above.to(torch.int32).sum(dim=0)
    majority_is_above = n_above * 2 >= m
    M = torch.where(majority_is_above[None], above, ~above)
    return M.sum(dim=1).to(dtype)


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
    full mask is bit-identical to :func:`column_mean_ref`.  Every row is
    summed, weight 0 included (``s + w_i·g_i``, as the JAX package's
    ``masked_mean_det`` and its Pallas ``w @ g`` do), so a column where a
    row of weight 0 holds NaN or ±inf comes out NaN (0·NaN and 0·inf are
    NaN); on finite rows ``s + 0·g`` is ``s`` bit for bit (the sum is
    never -0).  Callers that must keep a dropped row out zero it first
    (the elastic path).  Σw is summed in row order too, so float weights
    give the same bits on every device (the combine kernels sum it in
    the same order)."""
    Gf = G.to(torch.float32)
    w = mask.to(torch.float32)
    s = torch.zeros_like(Gf[0])
    for i in range(Gf.shape[0]):
        s = s + w[i] * Gf[i]
    return s / _guarded(det_sum_rows(w))


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


def brsgd_rank_indices(m: int, beta: float):
    """The :func:`rank_select` indices of the two cutoffs over m workers:
    (m - k for the kth score, k = max(1, ⌈β·m⌉); the lower quartile of
    l1, the auto 𝔗)."""
    k = max(1, math.ceil(beta * m))
    return m - k, quantile_nearest_index(0.25, m)


def brsgd_thresholds(scores, l1, beta: float, threshold: float):
    """Resolved C1/C2 cutoffs of paper Algorithm 2: (kth score, 𝔗),
    both counting quantiles; k = max(1, ⌈β·m⌉)."""
    k_idx, q_idx = brsgd_rank_indices(scores.shape[0], beta)
    kth = rank_select(scores, k_idx)
    if threshold > 0:
        T = torch.tensor(threshold, dtype=torch.float32, device=l1.device)
    else:
        T = rank_select(l1, q_idx)
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


class BrSGDAggregate(NamedTuple):
    """One local BrSGD aggregation: the aggregate and its diagnostics."""
    agg: torch.Tensor          # [d] Σ w_i g_i / Σ w_i
    w: torch.Tensor            # [m] f32 selection weights
    selected: torch.Tensor     # [m] bool, C1 ∩ C2 (after the fallback)
    c1: torch.Tensor           # [m] bool, l1 <= 2𝔗
    c2: torch.Tensor           # [m] bool, score >= kth
    scores: torch.Tensor       # [m]
    l1: torch.Tensor           # [m]
    kth: torch.Tensor          # the resolved score cutoff
    threshold: torch.Tensor    # the resolved 𝔗


def brsgd_aggregate_plain(G, beta: float, threshold: float) -> BrSGDAggregate:
    """Local BrSGD from G [m, d] to the aggregate: the (scores, l1) pass,
    the resolved thresholds, the masks and the row-order masked mean —
    the function the fused kernel computes in one launch."""
    st = fused_stats_ref(G, ("scores", "l1"))
    scores, l1 = st["scores"], st["l1"]
    kth, T = brsgd_thresholds(scores, l1, beta, threshold)
    sel, c1, c2 = brsgd_masks(scores, l1, kth, T)
    w = sel.to(torch.float32)
    return BrSGDAggregate(masked_mean_det(G, w), w, sel, c1, c2, scores, l1,
                          kth, T)


# ---------------------------------------------------------------------------
# the gram rules (krum, multi_krum, geomedian) and the mean, fixed worker set
# ---------------------------------------------------------------------------

def krum_scores(gram, n_close: int):
    """Krum score_i = Σ of the n_close smallest d²_ij over j, from the
    Gram matrix: d²_ij = (S_ii + S_jj) − 2 S_ij, self-distance +inf.
    torch.sort puts NaN last."""
    m = gram.shape[0]
    diag = torch.diagonal(gram)
    d2 = diag[:, None] + diag[None, :] - 2.0 * gram
    d2 = d2 + torch.diag(torch.full((m,), math.inf, device=gram.device))
    return torch.sort(d2, dim=1).values[:, :n_close].sum(dim=1)


def krum_weights(score):
    """One-hot on argmin(score): the first NaN if a score is NaN (as
    torch.argmin and jnp.argmin), else the first minimum."""
    w = torch.nn.functional.one_hot(torch.argmin(score), score.shape[0])
    return w.to(torch.float32)


def multi_krum_weights(score, k: int):
    """1.0 on the k best scores by a stable argsort (NaN last, ties by
    worker index, as jnp.argsort), 0.0 elsewhere."""
    order = torch.argsort(score, stable=True)
    w = torch.zeros(score.shape, dtype=torch.float32, device=score.device)
    w[order[:k]] = 1.0
    return w


def geomedian_weights(S, d2med, iters: int, eps: float, vf=None):
    """Weiszfeld in weight space (``engine._geomedian_select``): from
    w = 1/max(√d2med, eps), iters − 1 updates w_i = 1/max(‖g_i − z‖,
    eps) with ‖g_i − z‖² = S_ii − 2(Sw)_i/W + wᵀSw/W² from the Gram
    matrix S.  ``vf`` ([m] 0/1) re-masks the weights on every update
    (an elastic round).  NaN propagates (torch.clamp keeps it)."""
    diag = torch.diagonal(S)
    w = 1.0 / torch.clamp(torch.sqrt(d2med), min=eps)
    if vf is not None:
        w = w * vf
    for _ in range(max(iters - 1, 0)):
        W = w.sum()
        Sw = S @ w
        d2 = diag - 2.0 * Sw / W + (w @ Sw) / (W * W)
        w = 1.0 / torch.clamp(torch.sqrt(torch.clamp(d2, min=0.0)), min=eps)
        if vf is not None:
            w = w * vf
    return w


SELECT_RULES = ("mean", "krum", "multi_krum", "geomedian")


class SelectAggregate(NamedTuple):
    """One local aggregation of a select rule: the aggregate and its
    diagnostics (None where the rule has no such statistic)."""
    agg: torch.Tensor          # [d] Σ w_i g_i / Σ w_i
    w: torch.Tensor            # [m] f32 combine weights
    selected: torch.Tensor     # [m] bool, w > 0
    scores: torch.Tensor | None   # [m] krum scores (krum, multi_krum)
    gram: torch.Tensor | None     # [m, m] (krum, multi_krum, geomedian)
    d2med: torch.Tensor | None    # [m] (geomedian)


def select_aggregate_plain(G, rule: str, n_close: int = 1, k: int = 0,
                           iters: int = 1, eps: float = 1e-6) -> SelectAggregate:
    """A select rule over a fixed worker set, from G [m, d] to the
    aggregate: the rule's statistics (one shared pass), its weights and
    the row-order weighted mean — the function the fused kernel computes
    in one launch (B3 alone for the mean).  ``n_close``: krum's window;
    ``k``: multi_krum's count; ``iters``, ``eps``: geomedian's."""
    if rule not in SELECT_RULES:
        raise ValueError(f"unknown select rule {rule!r}; "
                         f"expected one of {SELECT_RULES}")
    m = G.shape[0]
    if rule == "mean":
        w = torch.ones((m,), dtype=torch.float32, device=G.device)
        return SelectAggregate(masked_mean_det(G, w), w, w > 0, None, None,
                               None)
    needs = ("d2med", "gram") if rule == "geomedian" else ("gram",)
    st = fused_stats_ref(G, needs)
    scores = None
    if rule == "geomedian":
        w = geomedian_weights(st["gram"], st["d2med"], iters, eps)
    else:
        scores = krum_scores(st["gram"], n_close)
        w = (krum_weights(scores) if rule == "krum"
             else multi_krum_weights(scores, k))
    return SelectAggregate(masked_mean_det(G, w), w, w > 0, scores,
                           st["gram"], st.get("d2med"))


def trim_k(trim_frac: float, m: int) -> int:
    """Per-side trim count k = ⌊trim_frac·m⌋, guarded so at least one
    row survives."""
    k = int(trim_frac * m)
    if 2 * k >= m:
        k = (m - 1) // 2
    return k


def trimmed_mean_ref(G, trim_frac: float):
    """Coordinate-wise trimmed mean (Yin et al. 2018): the sorted rows
    k..m-k-1 summed in row order from rows[k], IEEE-divided by m - 2k,
    with k = :func:`trim_k`.  One summation for every m (the JAX
    package's stack switch at m >= 33 is a CPU fusion workaround)."""
    m = G.shape[0]
    k = trim_k(trim_frac, m)
    S = sorted_worker_stack(G)
    acc = S[k]
    for i in range(k + 1, m - k):
        acc = acc + S[i]
    return exact_div(acc, float(m - 2 * k))


# ---------------------------------------------------------------------------
# elastic (masked) statistics: pad-to-max-m + validity mask
# ---------------------------------------------------------------------------
# Every function below takes ``valid`` ([m] 0/1) naming the active worker
# slots of a padded round.  Dropped slots become exact zeros (``where``,
# never a multiplicative 0 that would turn inf into NaN), cutoffs and
# counts are taken over the active set only, and every count stays a
# tensor on G's device, so no call waits on the host.

def quantile_index_dyn(q: float, n):
    """:func:`quantile_nearest_index` for a count held in a tensor: the
    same virtual index q·(n-1) in float32 and the same half-down tie
    rule."""
    virt = q * (n.to(torch.float32) - 1.0)
    low = torch.floor(virt)
    return torch.where(virt - low <= 0.5, low, low + 1.0).to(torch.int64)


def masked_sorted_stack(x, valid):
    """:func:`sorted_worker_stack` with the dropped rows forced to +inf:
    rows [0, n_active) are the ascending sort of the active values."""
    vb = (valid != 0)[:, None]
    return sorted_worker_stack(torch.where(vb, x.to(torch.float32),
                                           math.inf))


def masked_median_from_stack(S, n_active):
    """Median over the first ``n_active`` sorted rows (the two middle
    rows averaged; an odd count reads the middle row twice, and
    0.5·(a+a) == a).  A non-finite median becomes 0, so an empty round
    gives zeros, never 0·inf."""
    na = torch.clamp(n_active.to(torch.int64), min=1)
    lo = S.index_select(0, ((na - 1) // 2).reshape(1))[0]
    hi = S.index_select(0, (na // 2).reshape(1))[0]
    med = 0.5 * (lo + hi)
    return torch.where(torch.isfinite(med), med, torch.zeros_like(med))


def masked_stat_refs(G, needs, valid) -> dict:
    """The [d]-space invariants of the active set, computed once per G:
    the zeroed rows ``x``, ``v`` and ``na``; the column mean and majority
    side (``scores``); the coordinate-wise median (``l1``/``d2med``).

    Each per-worker statistic is a function of that worker's row and of
    these shared references only, which is what makes the streaming fold
    (``engine.stream_leaf_stats``) bit-exact with the bulk pass."""
    v = valid.to(torch.float32)
    x = torch.where(v[:, None] > 0, G.to(torch.float32), 0.0)
    na = v.sum()
    refs = {"x": x, "v": v, "na": na}
    if "scores" in needs:
        mean_c = exact_div(det_sum_rows(x), torch.clamp(na, min=1.0))
        n_above = torch.zeros_like(mean_c)
        for i in range(x.shape[0]):
            n_above = n_above + v[i] * (x[i] >= mean_c).to(torch.float32)
        refs["mean_c"] = mean_c
        refs["majority_is_above"] = n_above * 2.0 >= na
    if "l1" in needs or "d2med" in needs:
        refs["med"] = masked_median_from_stack(
            masked_sorted_stack(x, v), (v != 0).sum())
    return refs


def masked_fused_stats_ref(G, needs, valid, rows=None, refs=None) -> dict:
    """Masked :func:`fused_stats_ref`: statistics of the active workers,
    every dropped slot an exact zero.

    ``rows`` ([m] 0/1) restricts the output slots to one arrival bucket;
    ``refs`` reuses a :func:`masked_stat_refs` result so every bucket
    shares the same active-set invariants.  Slot i depends only on row i
    and the refs, so partials over any partition of the active set sum
    (over disjoint slots, x + 0 == x) to the bulk ``rows=None`` pass."""
    if refs is None:
        refs = masked_stat_refs(G, needs, valid)
    x, v = refs["x"], refs["v"]
    r = v if rows is None else v * rows.to(torch.float32)
    out = {}
    if "scores" in needs:
        mean_c = refs["mean_c"]
        side = torch.where(refs["majority_is_above"][None], x >= mean_c[None],
                           x < mean_c[None])
        out["scores"] = r * side.to(torch.float32).sum(dim=1)
    if "l1" in needs or "d2med" in needs:
        diff = x - refs["med"][None]
        if "l1" in needs:
            out["l1"] = r * diff.abs().sum(dim=1)
        if "d2med" in needs:
            out["d2med"] = r * (diff * diff).sum(dim=1)
    if "gram" in needs:
        xr = torch.where(r[:, None] > 0, x, 0.0)
        out["gram"] = xr @ x.T
    return out


def masked_cwise_median_ref(G, valid):
    """Coordinate-wise median over the active rows."""
    return masked_median_from_stack(masked_sorted_stack(G, valid),
                                    (valid != 0).sum())


def masked_trimmed_mean_ref(G, trim_frac: float, valid):
    """Coordinate-wise trimmed mean over the active rows: per-side trim
    k = ⌊trim_frac·n_active⌋ (float32 product) with the :func:`trim_k`
    guard, both counts tensors."""
    m = G.shape[0]
    S = masked_sorted_stack(G, valid)
    na = (valid != 0).sum()
    k = (trim_frac * na.to(torch.float32)).to(torch.int64)
    k = torch.where(2 * k >= na, torch.clamp(na - 1, min=0) // 2, k)
    ranks = torch.arange(m, device=G.device)[:, None]
    kept = torch.where((ranks >= k) & (ranks < na - k), S, 0.0)
    return exact_div(det_sum_rows(kept),
                     torch.clamp(na - 2 * k, min=1).to(torch.float32))


def masked_brsgd_select(scores, l1, beta: float, threshold: float, valid):
    """Masked :func:`brsgd_select_mask`: both cutoffs are counting
    quantiles over the active workers (k = ⌈β·n_active⌉ in float32,
    clamped to [1, n_active]; auto-𝔗 the lower quartile of the active
    l1 at :func:`quantile_index_dyn`), and no mask selects a dropped
    worker.  Returns (selected, c1, c2, 𝔗)."""
    m = scores.shape[0]
    v = valid != 0
    na = torch.clamp(v.sum(), min=1)
    k = torch.minimum(torch.clamp(torch.ceil(
        beta * na.to(torch.float32)).to(torch.int64), min=1), na)
    # dropped slots take -inf scores / +inf l1, so the active order
    # statistics sit in known rank windows of the full m-vector
    kth = rank_select(torch.where(v, scores, -math.inf), m - k)
    if threshold > 0:
        T = torch.tensor(threshold, dtype=torch.float32, device=l1.device)
    else:
        T = rank_select(torch.where(v, l1, math.inf),
                        quantile_index_dyn(0.25, na))
    c1 = v & (l1 <= 2.0 * T)
    c2 = v & (scores >= kth)
    sel = c1 & c2
    return torch.where(sel.any(), sel, c2), c1, c2, T


# ---------------------------------------------------------------------------
# attention (B6) and the WKV6 scan (B7)
# ---------------------------------------------------------------------------

NEG_INF = -1e30
WKV_LOG_CLAMP = 40.0


def attention_mask(S: int, T: int, window: int, device):
    """[S, T] bool: query i sees key j iff j <= i and (window == 0 or
    i - j < window) — the model's ``_causal_window_mask``."""
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(T, device=device)[None, :]
    mask = kp <= qp
    if window:
        mask &= (qp - kp) < window
    return mask


def flash_attention_ref(q, k, v, window: int = 0):
    """q [B,H,S,D], k [B,Hkv,T,D], v [B,Hkv,T,Dv] (H a multiple of Hkv)
    -> [B,H,S,Dv] in q's dtype: causal softmax attention in float32,
    scaled by 1/√D, with query head h on kv head h // (H/Hkv), masked
    logits at -1e30.  The twin of the JAX package's
    ``flash_attention_ref`` (causal=True, the only form the models run);
    the function B6 computes.  Dv may differ from D (MLA's q/k 96, v
    64)."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = H // Hkv
    kx = k.float().repeat_interleave(G, dim=1)
    vx = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kx) / math.sqrt(D)
    mask = attention_mask(S, T, window, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w, vx).to(q.dtype)


def wkv6_chunk_plain(r, k, v, w, u, S_in):
    """One RWKV-6 chunk in the factorised form B7 computes (the twin of
    the Pallas ``_wkv_chunk_kernel`` and of one step of
    ``rwkv6._wkv_chunked``'s scan body).

    r/k/v/w [B,H,Q,K] float32 (w the per-channel decay in (0, 1]),
    u [H,K], S_in [B,H,K,K] -> (y [B,H,Q,K], S_out [B,H,K,K]).
    c is the inclusive cumulative log-decay, ce the exclusive one; the
    intra-chunk factors are centred on half the chunk's decay and
    clipped at ±40, the state factors floored at -80.  The [Q,Q] scores
    are strictly lower triangular (``where``: an entry above the
    diagonal never reaches y, even where its clipped factors overflow).
    """
    lc = WKV_LOG_CLAMP
    logw = torch.log(w)
    c = torch.cumsum(logw, dim=2)                       # inclusive
    ce = c - logw                                       # exclusive
    mid = 0.5 * c[:, :, -1:]
    r_dec = r * torch.exp(torch.clamp(ce - mid, -lc, lc))
    k_grow = k * torch.exp(torch.clamp(mid - c, -lc, lc))
    Q = r.shape[2]
    A = r_dec @ k_grow.transpose(-1, -2)                # [B,H,Q,Q]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=r.device).tril(-1)
    A = torch.where(tri, A, torch.zeros_like(A))
    y = A @ v
    y = y + (r * u[None, :, None, :] * k).sum(-1, keepdim=True) * v
    y = y + (r * torch.exp(torch.clamp(ce, min=-2 * lc))) @ S_in
    k_end = k * torch.exp(torch.clamp(c[:, :, -1:] - c, min=-2 * lc))
    S_out = (torch.exp(torch.clamp(c[:, :, -1], min=-2 * lc))[..., None]
             * S_in + k_end.transpose(-1, -2) @ v)
    return y, S_out


def wkv6_seq_plain(r, k, v, w, u, S_in, chunk: int):
    """The chunked WKV6 scan B7 computes in one launch: r/k/v/w [B,S,H,K]
    float32, u [H,K], S_in [B,H,K,K] -> (y [B,S,H,K], S_final), as
    :func:`wkv6_chunk_plain` over chunks of Q = min(chunk, S) tokens,
    carrying the state (the JAX ``rwkv6._wkv_chunked`` scan).  The cumsum,
    mid and the clamps stay local to each chunk.  A ragged last chunk of
    Q' < Q tokens is computed over its Q' tokens: the JAX pad (w = 1,
    zeros) adds log 1 = 0 to c and 0 to every sum, so the two agree."""
    S = r.shape[1]
    Q = min(int(chunk), S)
    state, ys = S_in, []
    for c0 in range(0, S, Q):
        part = [x[:, c0:c0 + Q].transpose(1, 2) for x in (r, k, v, w)]
        y, state = wkv6_chunk_plain(*part, u, state)
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1), state


def wkv6_chunk_ref(r, k, v, w, u, S_in):
    """Sequential oracle of the chunk: the per-token recurrence
    y_t = r_t·(S + diag(u)·k_t v_tᵀ), S <- diag(w_t)·S + k_t v_tᵀ (the
    twin of the JAX package's ``wkv6_chunk_ref``).  Equal to
    :func:`wkv6_chunk_plain` wherever the clamps do not bite."""
    S = S_in.float()
    ys = []
    for t in range(r.shape[2]):
        rt, kt, vt, wt = (x[:, :, t].float() for x in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhk,bhkj->bhj", rt,
                               S + u[None, :, :, None] * kv))
        S = wt[..., None] * S + kv
    return torch.stack(ys, dim=2), S


# ---------------------------------------------------------------------------
# the plain gradients B6's and B7's backward kernels are held to (tests and
# the chip smoke; nothing on the card's path calls them)
# ---------------------------------------------------------------------------

def _grads(fn, inputs, grad_outputs):
    """autograd's gradients of fn(*inputs) (float32 leaves copied from
    ``inputs``) for the given output gradients, None for an input that
    does not reach the outputs."""
    leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
    with torch.enable_grad():
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None]
        return torch.autograd.grad([o for o, _ in pairs],
                                   leaves, [g for _, g in pairs],
                                   allow_unused=True)


def flash_attention_grads_ref(q, k, v, dO, window: int = 0):
    """(dq, dk, dv): autograd's gradient of :func:`flash_attention_ref`
    at (q, k, v) for the output gradient dO."""
    return _grads(lambda a, b, c: flash_attention_ref(a, b, c, window),
                  (q, k, v), (dO,))


def wkv6_seq_grads_plain(r, k, v, w, u, S_in, chunk: int, dy,
                         dS_final=None):
    """(dr, dk, dv, dw, du, dS_in): autograd's gradient of
    :func:`wkv6_seq_plain` for the output gradients dy and dS_final
    (None: the final state is not used)."""
    g = _grads(lambda *x: wkv6_seq_plain(*x, chunk), (r, k, v, w, u, S_in),
               (dy, dS_final))
    return tuple(torch.zeros_like(x) if d is None else d
                 for d, x in zip(g, (r, k, v, w, u, S_in)))


def wkv6_seq_grads_chunked(r, k, v, w, u, S_in, chunk: int, dy,
                           dS_final=None):
    """(dr, dk, dv, dw, du, dS_in) of :func:`wkv6_seq_plain` by the three
    passes of B7's backward kernels (``csrc/wkv6_bwd.cu``), written out
    with their formulas; the tests hold it against autograd and against
    JAX, nothing on the card's path calls it.

    With per chunk c of Q tokens (the last one padded with w = 1 and
    zeros, as the kernels zero-fill its rows): ce = c - log w, cl = c at
    the chunk's end, mid = cl / 2, RD = r·e^{clip(ce - mid, ±40)}, KG =
    k·e^{clip(mid - c, ±40)}, RS = r·e^{max(ce, -80)}, KE =
    k·e^{max(cl - c, -80)}, ecl = e^{max(cl, -80)} and S_c the state the
    chunk starts from:

    1. chunk-local carry terms P_c = RS_cᵀ·dy_c;
    2. the carry scan from the last chunk: dS_out_c is the running carry
       (dS_final or 0 at the end), then carry <- ecl_c ⊙rows carry + P_c;
       the last carry is dS_in;
    3. every chunk from its own inputs, S_c and dS_out_c: A = RD·KGᵀ and
       dA = dy·vᵀ on j < t; dv = Aᵀ·dy + KE·dS_out + diag·dy; dRD =
       dA·KG, dKG = dAᵀ·RD, dRS = dy·S_cᵀ, dKE = v·dS_outᵀ; dr, dk; each
       clamp passes its exponent's gradient where it does not bite
       (torch.clamp's rule), mid's and cl's are summed over the chunk's
       tokens, d(log w) is the suffix sum of dc minus dce, dw = d(log
       w) / w; du summed over chunks, then over b."""
    lc = WKV_LOG_CLAMP
    B, S, H, K = r.shape
    Q = min(int(chunk), S)
    C = -(-S // Q)
    states, state = [], S_in
    for c0 in range(0, S, Q):               # the forward's chunk states
        states.append(state)
        part = [x[:, c0:c0 + Q].transpose(1, 2) for x in (r, k, v, w)]
        _, state = wkv6_chunk_plain(*part, u, state)
    Sc = torch.stack(states, dim=2)                       # [B,H,C,K,K]

    def chunks(x, fill=0.0):                              # -> [B,H,C,Q,K]
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, C * Q - S),
                                    value=fill)
        return x.reshape(B, C, Q, H, K).permute(0, 3, 1, 2, 4)

    rc, kc, vc, dyc = (chunks(x) for x in (r, k, v, dy))
    wc = chunks(w, 1.0)
    lw = torch.log(wc)
    c = torch.cumsum(lw, dim=3)
    ce = c - lw
    cl = c[..., -1:, :]
    mid = 0.5 * cl
    aRD, aKG, aKE = ce - mid, mid - c, cl - c
    eRD = torch.exp(torch.clamp(aRD, -lc, lc))
    eKG = torch.exp(torch.clamp(aKG, -lc, lc))
    eRS = torch.exp(torch.clamp(ce, min=-2 * lc))
    eKE = torch.exp(torch.clamp(aKE, min=-2 * lc))
    RD, KG, RS, KE = rc * eRD, kc * eKG, rc * eRS, kc * eKE
    ecl = torch.exp(torch.clamp(cl, min=-2 * lc))[..., 0, :]   # [B,H,C,K]
    T = lambda x: x.transpose(-1, -2)                   # noqa: E731

    P = T(RS) @ dyc                                     # pass 1
    carry = (torch.zeros_like(P[:, :, 0]) if dS_final is None
             else dS_final.to(torch.float32))
    dS_out = torch.empty_like(P)
    for ci in reversed(range(C)):                       # pass 2
        dS_out[:, :, ci] = carry
        carry = ecl[:, :, ci, :, None] * carry + P[:, :, ci]

    tri = torch.ones((Q, Q), dtype=torch.bool, device=r.device).tril(-1)
    A = torch.where(tri, RD @ T(KG), 0.0)               # pass 3
    dA = torch.where(tri, dyc @ T(vc), 0.0)
    uu = u[None, :, None, None, :]
    diag = (rc * uu * kc).sum(-1, keepdim=True)
    ddiag = (dyc * vc).sum(-1, keepdim=True)
    dv = T(A) @ dyc + KE @ dS_out + diag * dyc
    dRD, dKG = dA @ KG, T(dA) @ RD
    dRS, dKE = dyc @ T(Sc), vc @ T(dS_out)
    decl = (Sc * dS_out).sum(-1)
    dr = dRD * eRD + dRS * eRS + ddiag * uu * kc
    dk = dKG * eKG + dKE * eKE + ddiag * rc * uu
    xRD = torch.where((aRD >= -lc) & (aRD <= lc), dRD * RD, 0.0)
    xKG = torch.where((aKG >= -lc) & (aKG <= lc), dKG * KG, 0.0)
    xRS = torch.where(ce >= -2 * lc, dRS * RS, 0.0)
    xKE = torch.where(aKE >= -2 * lc, dKE * KE, 0.0)
    dce = xRD + xRS
    dc = dce - xKG - xKE
    dmid = (xKG - xRD).sum(3)
    dcl = (xKE.sum(3) + torch.where(cl[..., 0, :] >= -2 * lc, decl * ecl,
                                    0.0) + 0.5 * dmid)
    run = torch.flip(torch.cumsum(torch.flip(dc, [3]), 3), [3])
    dw = (run + dcl[..., None, :] - dce) / wc
    du_b = (ddiag * rc * kc).sum(3).sum(2)              # over chunks
    du = du_b[0]
    for b in range(1, B):                               # then over b
        du = du + du_b[b]

    def unchunk(x):
        return x.permute(0, 2, 3, 1, 4).reshape(B, C * Q, H, K)[:, :S]

    return (unchunk(dr), unchunk(dk), unchunk(dv), unchunk(dw), du, carry)
