"""Robust-aggregation engine: the local layout (single-host G [m, d])
and the sharded ones (one rank a worker, ``torch.distributed``).

Port of the JAX package's ``core/engine.py``: the ``AggregatorSpec``
registry with all seven rules (mean, median, trimmed_mean, krum,
multi_krum, geomedian, brsgd), the replicated BrSGD selection,
``aggregate_local`` with its two-pass brsgd path, the elastic quorum
path — masked statistics over a ``valid`` mask and the streaming
accumulator — and ``aggregate_sharded`` in the "gather" and "a2a"
layouts or an explicit per-leaf plan, over a ``launch.mesh.Mesh``'s
process groups (``core/collectives.py``).  An :class:`AggregatorSpec`
declares WHAT a rule needs:

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
from ..models import params as PM
from . import collectives

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


# ---------------------------------------------------------------------------
# expected collectives of the sharded executors
# ---------------------------------------------------------------------------

def expected_collectives(spec: AggregatorSpec, layout: str, n_leaves: int,
                         fast_paths: bool = True, plan=None) -> dict:
    """Per-call counts of the data-moving collectives (all_gather /
    all_to_all) :func:`aggregate_sharded` issues; the all-reduces of
    its statistics and combines are not counted, as in the reference.

      gather  each leaf gathered once (the stats pass, or the column
              rule's view); the weighted combine gathers nothing.  A
              stat-free select (mean) gathers nothing.
      a2a     one all_to_all (chunk) and one all_gather (unchunk) a
              leaf; the mean's fast path (an all-reduce) neither.
      local   none.
      auto    the per-leaf sum over ``plan`` (a layout sequence or an
              object with ``layouts``), else :data:`LAST_PLAN`.
    """
    if layout == "local":
        return {"all_gather": 0, "all_to_all": 0}
    mean_fast = spec.name == "mean" and fast_paths
    if layout == "auto":
        plan = LAST_PLAN if plan is None else plan
        if plan is None:
            raise ValueError("layout='auto' needs the resolved plan "
                             "(none traced yet)")
        layouts = tuple(getattr(plan, "layouts", plan))
        if getattr(plan, "fast_path", False) or mean_fast:
            layouts = ()
        want = {"all_gather": 0, "all_to_all": 0}
        for ll in layouts:
            per = expected_collectives(spec, ll, 1, fast_paths)
            for k in want:
                want[k] += per[k]
        return want
    if layout == "a2a":
        n = 0 if mean_fast else n_leaves
        return {"all_gather": n, "all_to_all": n}
    if layout == "gather":
        needs_view = spec.column is not None or bool(spec.stats)
        return {"all_gather": n_leaves if needs_view else 0,
                "all_to_all": 0}
    raise ValueError(f"unknown layout {layout!r}")


def pad_correction(stats: dict, pad, valid=None) -> dict:
    """Remove the zero-pad columns' contribution (a2a layout): a zero
    column puts every worker at the column mean, so it is a majority
    column for every worker, +1 score per (active) worker per pad column;
    the median, l1, d2med and gram of zero columns are exactly zero."""
    if "scores" in stats and pad:
        stats = dict(stats)
        corr = torch.full_like(stats["scores"], float(pad))
        if valid is not None:
            corr = corr * valid.to(corr)
        stats["scores"] = stats["scores"] - corr
    return stats


# ---------------------------------------------------------------------------
# sharded executors: one rank a worker (and model shard), torch.distributed
# ---------------------------------------------------------------------------

def gather_leaf(g, mesh, axes, m: int):
    """All-gather one leaf over the worker axes to the worker-major
    [m, cols] float32 view (``flatten_columns``: the column kernels take
    2-D G).  The collective moves the leaf in its own dtype."""
    return collectives.all_gather(g, mesh, axes).reshape(m, -1).to(
        torch.float32)


def a2a_chunk(g, mesh, axes, m: int):
    """Flatten one leaf, zero-pad it to m·⌈D/m⌉ and all_to_all it over
    the worker axes -> ([m, ⌈D/m⌉] float32 chunk, row r worker r's values
    for this rank's column range; the pad column count)."""
    flat = g.reshape(-1)
    D = flat.numel()
    c = -(-D // m)
    x = torch.zeros((m * c,), dtype=g.dtype, device=g.device)
    x[:D] = flat
    Gc = collectives.all_to_all(x.view(m, c), mesh, axes).to(torch.float32)
    return Gc, m * c - D


def unchunk(vec, g, mesh, axes):
    """Re-assemble a rank's [⌈D/m⌉] result into the leaf's shape with a
    tiled all_gather, in the gradient's own dtype, cut to ``g.numel()``."""
    full = collectives.all_gather(vec.to(g.dtype), mesh, axes).reshape(-1)
    return full[:g.numel()].view(g.shape)


def _model_split(pspec, mesh, model_axes) -> int:
    """The number of model shards a leaf is cut into under ``pspec`` (1:
    replicated over the model axes)."""
    if pspec is None or not model_axes:
        return 1
    n = 1
    for entry in pspec:
        names = entry if isinstance(entry, tuple) else (entry,)
        hit = tuple(a for a in names if a in model_axes)
        if hit:
            n *= mesh.size(hit)
    return n


def _origin(mesh, axes) -> float:
    """1.0 on the ranks whose indices on ``axes`` are all zero, else 0.0:
    the mask that keeps a partial every such rank holds alike from being
    counted once per rank in a reduction across them."""
    return float(all(mesh.index((a,)) == 0 for a in axes))


# the most recent explicit plan resolved by aggregate_sharded (the
# reference's LAST_PLAN: introspection for tests)
LAST_PLAN = None


def _resolve_plan(leaves, layout, plan):
    """The per-leaf layouts of one aggregation: a fixed layout for every
    leaf, or for "auto" the explicit ``plan`` (a layout sequence or an
    object with ``layouts``).  The reference's cost model that resolves
    "auto" without a plan (``analysis/costmodel.plan_layouts``) is not
    ported: ROADMAP A.6."""
    global LAST_PLAN
    if layout != "auto":
        return (layout,) * len(leaves)
    if plan is None:
        raise ValueError(
            "layout='auto' without a plan needs the cost model "
            "(analysis/costmodel.plan_layouts), which is not ported yet "
            "(ROADMAP A.6): pass 'gather', 'a2a' or an explicit plan")
    layouts = tuple(getattr(plan, "layouts", plan))
    if len(layouts) != len(leaves):
        raise ValueError(f"layout plan covers {len(layouts)} leaves, "
                         f"tree has {len(leaves)}")
    bad = set(layouts) - {"gather", "a2a"}
    if bad:
        raise ValueError(f"layout plan contains unknown layouts {bad}")
    LAST_PLAN = plan
    return layouts


def _view_stats(Gv, needs, m: int, vf):
    """One worker view's statistic partials with the scores in double
    (exact counts past 2^24 columns, summed over views and ranks): the
    column pass on the view, or in an elastic round the masked statistics
    over blocks of :data:`ELASTIC_BLOCK` columns."""
    if vf is None:
        return ops.fused_stats(Gv, needs, scores_dtype=torch.float64)
    d = Gv.shape[1]
    parts = [leaf_stats(Gv[:, a:min(a + ELASTIC_BLOCK, d)], needs, m,
                        valid=vf) for a in range(0, d, ELASTIC_BLOCK)]
    tot = {}
    for k in parts[0]:
        dt = torch.float64 if k == "scores" else torch.float32
        tot[k] = parts[0][k].to(dt)
        for p in parts[1:]:
            tot[k] = tot[k] + p[k].to(dt)
    return tot


def aggregate_sharded(grads, cfg: ByzantineConfig, mesh, axes=("data",),
                      layout: str = "gather",
                      spec: AggregatorSpec | None = None, model_axes=(),
                      leaf_specs=None, valid=None, plan=None):
    """Aggregate this rank's gradient leaves across the worker axes of
    ``mesh`` -> (aggregate, the same on every worker with its model
    shards intact; state | None).  ``grads`` is a nested dict (sorted
    keys) or a list; every rank of the worker group calls this with
    leaves of the same shapes.

    ``gather``: each leaf all-gathered once to [m, cols] for the
    statistics (or the column rule), and the combine an all-reduce of
    each worker's own wᵢgᵢ in float32 over Σw (never a second gather).
    ``a2a``: each leaf flattened, zero-padded to m·⌈D/m⌉ and
    all_to_all'd, so a rank holds every worker for 1/m of the columns;
    the chunks are kept, the statistic partials closed by one
    all-reduce, and the aggregated chunk re-assembled with a tiled
    all_gather.  ``auto`` takes an explicit per-leaf ``plan``; without
    one it raises (the cost model is ROADMAP A.6).  The statistics run
    on the worker views through ``kernels.ops`` (the column pass, or the
    gram kernel, on a CUDA view); scores are counted in double.

    ``model_axes``/``leaf_specs``: the tensor-parallel axes and each
    leaf's spec (:func:`models.params.pspec_tree`).  A model-sharded
    leaf is this rank's shard, its partials over disjoint columns;
    model-replicated leaves' partials are alike on every model shard and
    are masked to the model origin, and one all-reduce over worker and
    model axes closes both.  The worker views are always [m, cols] (the
    reference's ``flatten_columns=True``, which its global step passes).

    ``valid`` ([m] 0/1, the same on every rank) runs the elastic round:
    an inactive worker's leaves are zeroed first (exact zeros, whatever
    they held), the statistics and selection cover the active workers,
    and in the a2a layout the validity one-hot rides the statistics'
    all-reduce."""
    if layout not in ("gather", "a2a", "auto"):
        raise ValueError(f"unknown layout {layout!r}")
    spec = spec or get_spec(cfg.aggregator)
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    model_axes = tuple(model_axes)
    m = mesh.size(axes)
    me = mesh.index(axes)
    leaves, rebuild = PM.tree_flatten(grads)
    layouts = _resolve_plan(leaves, layout, plan)
    any_a2a = "a2a" in layouts
    spec_leaves = ([None] * len(leaves) if leaf_specs is None
                   else PM.tree_flatten(leaf_specs)[0])
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(spec_leaves)} leaf specs for "
                         f"{len(leaves)} leaves")
    dev = leaves[0].device
    # model-replicated leaves' partials counted once across model shards
    origin = _origin(mesh, model_axes) if model_axes else None
    elastic = valid is not None
    vf = None
    if elastic:
        vf = torch.as_tensor(valid).to(device=dev, dtype=torch.float32)
        if float(vf[me]) <= 0:
            leaves = [torch.zeros_like(g) for g in leaves]

    if spec.name == "mean" and not elastic:
        # uniform weights: an all-reduce mean, no gather / a2a
        out = [collectives.all_reduce(g.clone(), mesh, axes) / m
               for g in leaves]
        return rebuild(out), None

    # -- per-dimension rules: no replicated phase -----------------------
    if spec.column is not None:
        out = []
        for g, ll in zip(leaves, layouts):
            if ll == "a2a":
                Gc, _pad = a2a_chunk(g, mesh, axes, m)
                out.append(unchunk(spec.column(Gc, cfg, m, valid=vf), g,
                                   mesh, axes))
                continue
            col = spec.column(gather_leaf(g, mesh, axes, m), cfg, m,
                              valid=vf)
            out.append(col.to(g.dtype).reshape(g.shape))
        st = SelectionState(vf > 0, vf) if elastic else None
        return rebuild(out), st

    # -- phase 1: per-leaf statistic partials ---------------------------
    # gather: each leaf gathered once, its view dropped after the stats
    # (one gathered leaf live at a time); a2a: the chunks are kept (1/m of
    # the columns of every worker, 1x in all) for the combine
    needs = tuple(sorted(spec.stats))
    stats = {k: torch.zeros((m, m) if k == "gram" else (m,),
                            dtype=torch.float64 if k == "scores"
                            else torch.float32, device=dev)
             for k in needs}
    cached, total_pad = [], 0
    # a mixed plan's gather-leaf partials (from the full gathered view,
    # alike on every worker) counted once when the a2a leaves' reduction
    # runs over the workers
    worigin = _origin(mesh, axes) if any_a2a else None
    for g, ps, ll in zip(leaves, spec_leaves, layouts):
        n_split = _model_split(ps, mesh, model_axes)
        if ll == "a2a":
            Gv, pad = a2a_chunk(g, mesh, axes, m)
            # each model shard pads its own chunk and the all-reduce sums
            # them: a sharded leaf brings n_split pads
            total_pad += pad * n_split
            cached.append(Gv)
        elif not needs:
            cached.append(None)
            continue            # stat-free select (mean): nothing to gather
        else:
            Gv = gather_leaf(g, mesh, axes, m)
            cached.append(None)
        part = _view_stats(Gv, needs, m, vf)
        scale = 1.0
        if origin is not None and n_split == 1:
            scale *= origin     # model-replicated: the origin's copy only
        if worigin is not None and ll == "gather":
            scale *= worigin    # worker-replicated gather partial
        for k in stats:
            stats[k] += part[k] * scale if scale != 1.0 else part[k]
        del Gv
    if stats and (any_a2a or model_axes):
        # a2a partials close over the worker axes, model-sharded leaves'
        # over the model axes, in the same reduction
        red_axes = (axes if any_a2a else ()) + model_axes
        if elastic and any_a2a:
            # the validity one-hot rides the statistics' all-reduce (each
            # worker its own slot, at the model origin only)
            vpart = torch.zeros((m,), dtype=torch.float32, device=dev)
            vpart[me] = 1.0
            vpart = vpart * vf[me]
            stats["valid"] = vpart if origin is None else vpart * origin
        flat32 = [k for k in stats if k != "scores"]
        if flat32:
            buf = torch.cat([stats[k].reshape(-1) for k in flat32])
            collectives.all_reduce(buf, mesh, red_axes)
            a = 0
            for k in flat32:
                n = stats[k].numel()
                stats[k] = buf[a:a + n].view(stats[k].shape)
                a += n
        if "scores" in stats:
            collectives.all_reduce(stats["scores"], mesh, red_axes)
        stats = pad_correction(stats, total_pad, valid=vf)
    if "scores" in stats:
        stats["scores"] = stats["scores"].to(torch.float32)
    if elastic:
        stats = dict(stats)
        stats.setdefault("valid", vf)

    # -- phase 2: replicated selection and the weighted combine ---------
    w, st, denom = resolve_select(spec, stats, cfg, m, dev)
    out = []
    # gather-free combine: Σᵢ wᵢgᵢ is an all-reduce of each worker's own
    # weighted gradient in float32, over Σw
    wi = w[me] if "gather" in layouts else None
    for g, Gv, ll in zip(leaves, cached, layouts):
        if ll == "a2a":
            out.append(unchunk(torch.tensordot(w, Gv, dims=1) / denom, g,
                               mesh, axes))
        else:
            part = (wi * g.to(torch.float32)).contiguous()
            agg = collectives.all_reduce(part, mesh, axes) / denom
            out.append(agg.to(g.dtype))
    return rebuild(out), st
