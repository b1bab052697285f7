"""Robust-aggregation engine, local layout (single-host G [m, d]).

Port of the JAX package's ``core/engine.py`` up to its sharded
executors: the ``AggregatorSpec`` registry with all seven rules (mean,
median, trimmed_mean, krum, multi_krum, geomedian, brsgd), the
replicated BrSGD selection, ``aggregate_local`` with its two-pass brsgd
path, and the elastic quorum path — masked statistics over a ``valid``
mask and the streaming accumulator.  An :class:`AggregatorSpec` declares
WHAT a rule needs:

* ``stats``  — a subset of :data:`STAT_NAMES` (scores [m], l1 [m],
  d2med [m], gram [m, m]), all additive over dimension ranges;
* ``select`` — ``(stats, cfg, m) -> (weights [m], state | None)`` on
  [m]-sized inputs, followed by the weighted row combine; or
* ``column`` — ``(G [m, d], cfg, m, valid=None) -> [d]`` for
  per-dimension rules.

Statistics and combines go through :mod:`..kernels.ops`: the CUDA
kernels for a CUDA G, the plain versions for a CPU G.  In an elastic
round the validity mask rides the stats dict under ``"valid"``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import Callable, NamedTuple, Optional

import torch

from ..configs.base import ByzantineConfig
from ..kernels import ops, ref

STAT_NAMES = ref.STAT_NAMES

GEOMEDIAN_ITERS = 16
GEOMEDIAN_EPS = 1e-6


# ---------------------------------------------------------------------------
# BrSGD selection (paper Algorithm 2) — the replicated phase
# ---------------------------------------------------------------------------

class SelectionState(NamedTuple):
    """Diagnostics for select rules with no richer state (krum: one
    row).  ``selected`` feeds the training loop's n_selected metric."""
    selected: torch.Tensor     # [m] bool — rows with nonzero combine weight
    weights: torch.Tensor      # [m] f32 — the combine weights


class BrSGDState(NamedTuple):
    """Diagnostics of one BrSGD aggregation call."""
    selected: torch.Tensor     # [m] bool — C1 ∩ C2 (after fallback)
    c1: torch.Tensor           # [m] bool — l1 filter
    c2: torch.Tensor           # [m] bool — top-beta score filter
    scores: torch.Tensor       # [m]
    l1: torch.Tensor           # [m]
    threshold: torch.Tensor    # resolved 𝔗


def brsgd_select(scores, l1, beta: float, threshold: float) -> BrSGDState:
    """Constraint 1 (ℓ1 ≤ 2𝔗) ∩ Constraint 2 (top-β by score);
    threshold <= 0 selects the auto rule 𝔗 = lower quartile of l1."""
    sel, c1, c2, T = ref.brsgd_select_mask(scores, l1, beta, threshold)
    return BrSGDState(sel, c1, c2, scores, l1, T)


# ---------------------------------------------------------------------------
# per-leaf statistics
# ---------------------------------------------------------------------------

def leaf_stats(G, needs, m: int, valid=None, rows=None, refs=None) -> dict:
    """Partial statistics of the worker-major G [m, d] — one pass over
    G however many statistics the spec declared.

    ``valid`` ([m] 0/1) switches to the masked pass: statistics of the
    active workers only, dropped slots exact zeros.  ``rows``/``refs``
    scope the output to one arrival bucket against shared active-set
    invariants (:func:`stream_leaf_stats`)."""
    if not needs:
        return {}
    if valid is not None:
        return ops.fused_stats(G, tuple(sorted(needs)), valid=valid,
                               rows=rows, refs=refs)
    return ops.fused_stats(G, tuple(sorted(needs)))


def zero_stats(needs, m: int, device="cpu") -> dict:
    """Zero partial-stat accumulators for ``needs``."""
    return {k: torch.zeros((m, m) if k == "gram" else (m,),
                           dtype=torch.float32, device=device)
            for k in needs}


def resolve_select(spec, stats: dict, cfg, m: int, device):
    """Run a spec's select rule and resolve the combine denominator:
    ``(weights [m] on device, state, denom)`` with the empty-selection
    guard (Σw == 0 divides by 1) and a SelectionState when the rule has
    no richer state.

    In an elastic round the validity mask rides the stats dict under
    ``"valid"``: every rule masks its own quantiles and candidates, and
    the weights and ``selected`` are masked again here, so no rule can
    keep weight on a dropped worker."""
    w, st = spec.select(stats, cfg, m)
    w = w.to(device)
    valid = stats.get("valid")
    if valid is not None:
        on = valid.to(device) > 0
        w = w * on.to(torch.float32)
        if st is not None:
            st = st._replace(selected=st.selected & on)
    if st is None:
        st = SelectionState(w > 0, w)
    sw = w.sum()
    return w, st, torch.where(sw > 0, sw, torch.ones_like(sw))


# ---------------------------------------------------------------------------
# streaming (elastic) accumulator — arrival-order-invariant by construction
# ---------------------------------------------------------------------------
# Workers report in any order; their stat partials fold into a running
# state as they land.  Bit-exactness with the bulk masked leaf_stats pass
# holds by construction: each worker's output slots are non-zero in one
# bucket's partial only, the [d]-space invariants (column mean, majority
# side, median) are computed once from the full active set and shared by
# every bucket, and IEEE x + 0.0 == x makes the sum over disjoint slots
# the identity on each slot.

class StreamState(NamedTuple):
    """Running state of the streaming accumulator."""
    stats: dict             # per-worker stat partials folded so far
    valid: torch.Tensor     # [m] f32 — 1.0 once a worker's partial landed


def init_stream(needs, m: int, device="cpu") -> StreamState:
    return StreamState(zero_stats(needs, m, device),
                       torch.zeros((m,), dtype=torch.float32, device=device))


def fold_stats(state: StreamState, part: dict, valid) -> StreamState:
    """Fold one arrival bucket's per-worker stat partials (and its [m]
    0/1 arrival mask) into the running state."""
    return StreamState({k: state.stats[k] + part[k] for k in state.stats},
                       state.valid + valid.to(torch.float32))


def fold_arrivals(buffer, valid, rows, mask):
    """G-space half of the accumulator: write one arrival bucket's rows
    into the [m, d] buffer (disjoint slots, any order gives the same
    bits).  Returns (buffer', valid')."""
    mf = mask.to(torch.float32)
    return (torch.where(mf[:, None] > 0, rows, buffer),
            valid + mf)


def stream_leaf_stats(G, needs, m: int, arrival) -> StreamState:
    """Fold per-worker stat partials bucket by bucket.

    ``arrival`` [n_buckets, m]: disjoint 0/1 masks, bucket b holding the
    workers that landed in arrival slot b (their sum is the round's
    validity mask).  The active-set invariants are computed once
    (``ops.masked_stat_refs``); each bucket's partial is evaluated
    against them and folded.  The stats equal ``leaf_stats(G, needs, m,
    valid=arrival.sum(0))`` bit for bit for any bucketing or order."""
    arrival = arrival.to(torch.float32)
    valid = arrival.sum(dim=0)
    needs_t = tuple(sorted(needs))
    if not needs_t:
        return StreamState({}, valid)
    refs = ops.masked_stat_refs(G, needs_t, valid)
    state = init_stream(needs_t, m, G.device)
    for bmask in arrival:
        part = leaf_stats(G, needs_t, m, valid=valid, rows=bmask, refs=refs)
        state = fold_stats(state, part, bmask)
    return state


def quorum_met(valid, quorum: int):
    """True once at least ``quorum`` workers' partials have folded in."""
    return (valid > 0).sum() >= quorum


def arrival_active(arrival, quorum: int):
    """[m] f32 quorum mask from [n_buckets, m] arrival buckets: the
    first ``quorum`` workers in arrival order (bucket-major, ties within
    a bucket broken by worker index), everyone later dropped; workers
    that never arrive rank after all.  quorum 0 keeps everyone who
    arrived."""
    arrival = arrival.to(torch.float32)
    n_buckets, m = arrival.shape
    arrived = arrival.sum(dim=0) > 0
    if not quorum:
        return arrived.to(torch.float32)
    idx = torch.arange(m, device=arrival.device)
    bucket_of = torch.argmax(arrival, dim=0)            # first (only) bucket
    key = torch.where(arrived, bucket_of * m + idx, n_buckets * m + 1 + idx)
    rank = (key[None, :] < key[:, None]).sum(dim=1)
    return (arrived & (rank < quorum)).to(torch.float32)


def stream_aggregate(G, cfg: ByzantineConfig, arrival, spec=None,
                     return_state: bool = False):
    """Local quorum aggregation over a stream of arrival buckets:
    selection fires on the quorum prefix (:func:`arrival_active`, at
    most ``cfg.quorum`` workers), stats fold bucket by bucket
    (:func:`stream_leaf_stats`), and late arrivals are dropped (the
    state's ``selected`` never exceeds the quorum)."""
    spec = spec or get_spec(cfg.aggregator)
    G = G.to(torch.float32).contiguous()
    m = G.shape[0]
    arrival = arrival.to(device=G.device, dtype=torch.float32)
    active = arrival_active(arrival, cfg.quorum)
    if spec.column is not None:
        out = spec.column(G, cfg, m, valid=active)
        st = SelectionState(active > 0, active)
        return (out, st) if return_state else out
    state = stream_leaf_stats(G, spec.stats, m, arrival * active[None, :])
    stats = dict(state.stats)
    stats["valid"] = active
    w, st, _denom = resolve_select(spec, stats, cfg, m, G.device)
    Gz = torch.where(active[:, None] > 0, G, 0.0)
    agg = _combine_rows(Gz, w)
    return (agg, st) if return_state else agg


# ---------------------------------------------------------------------------
# aggregator registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AggregatorSpec:
    """Layout-independent description of one aggregation rule."""
    name: str
    stats: frozenset = frozenset()
    select: Optional[Callable] = None   # (stats, cfg, m) -> (w [m], state)
    column: Optional[Callable] = None   # (G [m, d], cfg, m) -> [d]

    def __post_init__(self):
        if (self.select is None) == (self.column is None):
            raise ValueError(
                f"{self.name}: exactly one of select/column must be set")
        unknown = set(self.stats) - set(STAT_NAMES)
        if unknown:
            raise ValueError(f"{self.name}: unknown stats {sorted(unknown)}")


_REGISTRY: dict[str, AggregatorSpec] = {}


def register(spec: AggregatorSpec) -> AggregatorSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_spec(name: str) -> AggregatorSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown aggregator {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def registered() -> tuple:
    return tuple(sorted(_REGISTRY))


# ---- selection rules -------------------------------------------------------
# Every rule handles the elastic case by reading the optional "valid" key
# of the stats dict: byzantine-tolerance counts (krum's f, brsgd's top-β)
# become tensors of the ACTIVE count, dropped workers' rows and columns
# are pushed to ±inf so they never win a quantile or a neighbour window,
# and the weights are zero on dropped slots.

def _ones_select(stats, cfg, m):
    valid = stats.get("valid")
    if valid is not None:
        return valid.to(torch.float32), None
    return torch.ones((m,), dtype=torch.float32), None


def _brsgd_select_rule(stats, cfg, m):
    valid = stats.get("valid")
    if valid is None:
        st = brsgd_select(stats["scores"], stats["l1"], cfg.beta,
                          cfg.threshold)
    else:
        sel, c1, c2, T = ref.masked_brsgd_select(
            stats["scores"], stats["l1"], cfg.beta, cfg.threshold, valid)
        st = BrSGDState(sel, c1, c2, stats["scores"], stats["l1"], T)
    return st.selected.to(torch.float32), st


def _krum_f(cfg, m: int) -> int:
    return cfg.krum_f if cfg.krum_f > 0 else max(1, int(cfg.alpha * m))


def _krum_f_dyn(cfg, na):
    """:func:`_krum_f` of an active count held in a tensor (float32
    product, as the JAX package computes it)."""
    if cfg.krum_f > 0:
        return torch.full_like(na, cfg.krum_f)
    return torch.clamp((cfg.alpha * na.to(torch.float32)).to(na.dtype),
                       min=1)


def _krum_n_close(cfg, m: int) -> int:
    return max(1, m - _krum_f(cfg, m) - 2)


def _multi_krum_k(cfg, m: int, n_select: int = 0) -> int:
    return min(m, n_select or max(1, m - _krum_f(cfg, m)))


def _krum_scores(gram, cfg, m: int, valid=None):
    """Krum score_i = Σ of the n-f-2 smallest d²_ij, from the Gram
    matrix (d²_ij = S_ii + S_jj − 2 S_ij, self-distance +inf).  n = m,
    or the active count in an elastic round, where dropped workers' rows
    and columns are +inf: they neither score nor sit in a window."""
    if valid is None:
        return ref.krum_scores(gram, _krum_n_close(cfg, m))
    diag = torch.diagonal(gram)
    d2 = diag[:, None] + diag[None, :] - 2.0 * gram
    d2 = d2 + torch.diag(torch.full((m,), float("inf"), device=gram.device))
    v = valid > 0
    na = v.sum()
    n_close = torch.clamp(na - _krum_f_dyn(cfg, na) - 2, min=1)
    d2 = torch.where(v[None, :], d2, float("inf"))
    d2s = torch.sort(d2, dim=1).values
    keep = torch.arange(m, device=gram.device)[None, :] < n_close
    score = torch.where(keep, d2s, 0.0).sum(dim=1)
    return torch.where(v, score, float("inf"))


def _krum_select(stats, cfg, m):
    score = _krum_scores(stats["gram"], cfg, m, stats.get("valid"))
    return ref.krum_weights(score), None


def _multi_krum_select(stats, cfg, m, n_select: int = 0):
    """The n_select rows with the best krum scores (default n - f),
    ties broken by worker index (a stable argsort, as jnp.argsort)."""
    valid = stats.get("valid")
    score = _krum_scores(stats["gram"], cfg, m, valid)
    if valid is None:
        return ref.multi_krum_weights(score, _multi_krum_k(cfg, m,
                                                           n_select)), None
    order = torch.argsort(score, stable=True)       # dropped (inf) last
    v = valid > 0
    na = v.sum()
    k = (torch.full_like(na, n_select) if n_select
         else torch.clamp(na - _krum_f_dyn(cfg, na), min=1))
    k = torch.minimum(torch.clamp(k, min=1), torch.clamp(na, min=1))
    ranked = (torch.arange(m, device=score.device) < k).to(torch.float32)
    w = torch.zeros((m,), dtype=torch.float32, device=score.device)
    w[order] = ranked
    return w * v.to(torch.float32), None


def _geomedian_select(stats, cfg, m, iters: int = GEOMEDIAN_ITERS,
                      eps: float = GEOMEDIAN_EPS):
    """Weiszfeld in weight space: z_t is always a row combination
    Σ w_i g_i / Σ w_i, so distances to it come from the Gram matrix
    (‖g_i − z‖² = S_ii − 2(Sw)_i/W + wᵀSw/W²).

    Starts from the coordinate-wise median (the ``d2med`` stat): from
    the mean, a scale-1e10 attack leaves Weiszfeld in the flat far field
    where every weight is equal.  An elastic round re-masks the weights
    on every iteration: a dropped slot's d2med is an exact zero, which
    would otherwise give it the 1/eps ceiling weight."""
    valid = stats.get("valid")
    vf = None if valid is None else (valid > 0).to(torch.float32)
    return ref.geomedian_weights(stats["gram"], stats["d2med"], iters, eps,
                                 vf), None


# ---- per-dimension (column) rules ------------------------------------------

def _median_column(G, cfg, m, valid=None):
    return ops.cwise_median(G, valid=valid)


def _trimmed_mean_column(G, cfg, m, valid=None):
    return ops.trimmed_mean(G, cfg.trim_frac, valid=valid)


# ---- registry entries (the 7 rules) ----------------------------------------

register(AggregatorSpec("mean", select=_ones_select))
register(AggregatorSpec("median", column=_median_column))
register(AggregatorSpec("trimmed_mean", column=_trimmed_mean_column))
register(AggregatorSpec("krum", stats=frozenset({"gram"}),
                        select=_krum_select))
register(AggregatorSpec("multi_krum", stats=frozenset({"gram"}),
                        select=_multi_krum_select))
register(AggregatorSpec("geomedian", stats=frozenset({"gram", "d2med"}),
                        select=_geomedian_select))
register(AggregatorSpec("brsgd", stats=frozenset({"scores", "l1"}),
                        select=_brsgd_select_rule))


def spec_with(name: str, **select_kwargs) -> AggregatorSpec:
    """Spec variant with keyword arguments bound into its select rule
    (multi_krum n_select, geomedian iters/eps)."""
    spec = get_spec(name)
    return replace(spec, select=partial(spec.select, **select_kwargs))


def rule_args(spec: AggregatorSpec, cfg, m: int) -> dict:
    """The host-side arguments of ``ops.select_aggregate`` for a fixed
    round of ``spec``: krum's window, multi_krum's count, geomedian's
    iterations and eps (the keywords :func:`spec_with` bound into
    ``spec.select``, else the rule's defaults)."""
    kw = getattr(spec.select, "keywords", {})
    if spec.name in ("krum", "multi_krum"):
        args = {"n_close": _krum_n_close(cfg, m)}
        if spec.name == "multi_krum":
            args["k"] = _multi_krum_k(cfg, m, kw.get("n_select", 0))
        return args
    if spec.name == "geomedian":
        return {"iters": kw.get("iters", GEOMEDIAN_ITERS),
                "eps": kw.get("eps", GEOMEDIAN_EPS)}
    return {}


# ---------------------------------------------------------------------------
# local executor — single-host G [m, d]
# ---------------------------------------------------------------------------

def _combine_rows(G, w):
    """Σ_i w_i g_i / Σ_i w_i, rows accumulated in order 0..m-1."""
    return ops.masked_mean(G, w)


# columns the elastic round reads at a time: [m, ELASTIC_BLOCK] floats of
# temporaries, and a score partial of at most 2^22 counts (a float holds
# it exactly); a G of at most this many columns is one block
ELASTIC_BLOCK = 1 << 22


def _sum_partials(parts: list) -> dict:
    """The blocks' statistics partials summed, in block order.  Score
    partials are whole counts: summed in double and rounded to float
    once, so the total is exact past 2^24 columns as the fixed round's
    is; one block is its own partial's bits."""
    tot = {}
    for k in parts[0]:
        if k == "scores":
            tot[k] = torch.stack([p[k] for p in parts]).sum(
                dim=0, dtype=torch.float64).to(torch.float32)
            continue
        tot[k] = parts[0][k]
        for p in parts[1:]:
            tot[k] = tot[k] + p[k]
    return tot


def _aggregate_masked(G, cfg, spec, vf, return_state: bool, inplace: bool):
    """The elastic round over blocks of :data:`ELASTIC_BLOCK` columns, with no
    [m, d] temporary but (without ``inplace``) one zeroed copy of G.

    The inactive rows are zeroed first, as the reference's ``where`` on
    entry does: in place with ``inplace`` (the train step owns its G),
    else in a copy.  A select rule's masked statistics are the sum of
    the blocks' ``leaf_stats`` partials (the statistics add over
    disjoint column ranges), then ``resolve_select`` and one combine over
    all of G; a column rule runs block by block (it works per column, so
    the blocks are exact)."""
    m, d = G.shape
    off = torch.nonzero(vf <= 0).flatten().tolist()
    if inplace:
        for r in off:
            G[r].zero_()
    elif off:
        G = torch.where(vf[:, None] > 0, G, 0.0)
    blocks = [(a, min(a + ELASTIC_BLOCK, d))
              for a in range(0, d, ELASTIC_BLOCK)]
    if spec.column is not None:
        out = torch.empty((d,), dtype=torch.float32, device=G.device)
        for a, b in blocks:
            out[a:b] = spec.column(G[:, a:b], cfg, m, valid=vf)
        st = SelectionState(vf > 0, vf)
        return (out, st) if return_state else out
    stats = _sum_partials([leaf_stats(G[:, a:b], spec.stats, m, valid=vf)
                           for a, b in blocks])
    stats["valid"] = vf
    w, st, _denom = resolve_select(spec, stats, cfg, m, G.device)
    agg = _combine_rows(G, w)
    return (agg, st) if return_state else agg


def aggregate_local(G, cfg: ByzantineConfig, return_state: bool = False,
                    spec: AggregatorSpec | None = None, valid=None,
                    inplace: bool = False):
    """Run one aggregator on the worker-gradient matrix G [m, d] -> [d].

    A fixed round of a select rule is one launch on the card.  brsgd
    takes ``ops.brsgd_aggregate``: pass 1 emits only the [m] partials
    (scores, l1), the thresholds are resolved, and pass 2 fuses selection
    with the masked mean, with no [d]-sized intermediate written.  krum,
    multi_krum and geomedian take ``ops.select_aggregate``: B1's gram
    pass, the rule on the card and B3's combine; the mean is B3 with unit
    weights.  Every state field is a view of what that launch wrote.

    ``valid`` ([m] 0/1) runs the elastic masked variant: statistics,
    quantiles and the combine cover the active rows only, and dropped
    rows contribute exact zeros.  The masked statistics are torch ops on
    G's device (``kernels.ops``); the combine is the masked-mean kernel
    on the zeroed rows, over column blocks (:func:`_aggregate_masked`);
    ``inplace`` lets it zero the inactive rows of G itself instead of a
    copy."""
    spec = spec or get_spec(cfg.aggregator)
    G = G.to(torch.float32).contiguous()
    m = G.shape[0]
    if valid is not None:
        vf = torch.as_tensor(valid).to(device=G.device, dtype=torch.float32)
        return _aggregate_masked(G, cfg, spec, vf, return_state, inplace)

    if spec.column is not None:
        out = spec.column(G, cfg, m)
        return (out, None) if return_state else out

    if spec.name == "brsgd":
        # one launch on the card: pass 1, the thresholds, pass 2; the
        # state is views of what that launch wrote
        r = ops.brsgd_aggregate(G, cfg.beta, cfg.threshold)
        if not return_state:
            return r.agg
        return r.agg, BrSGDState(r.selected, r.c1, r.c2, r.scores, r.l1,
                                 r.threshold)
    r = ops.select_aggregate(G, spec.name, **rule_args(spec, cfg, m))
    return (r.agg, SelectionState(r.selected, r.w)) if return_state \
        else r.agg
