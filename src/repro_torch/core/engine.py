"""Robust-aggregation engine, local layout (single-host G [m, d]).

Port of the JAX package's ``core/engine.py`` for the paper loop: the
``AggregatorSpec`` registry with mean, median, krum and brsgd, the
replicated BrSGD selection and ``aggregate_local`` with its two-pass
brsgd path.  An :class:`AggregatorSpec` declares WHAT a rule needs:

* ``stats``  — a subset of :data:`STAT_NAMES` (scores [m], l1 [m],
  d2med [m], gram [m, m]), all additive over dimension ranges;
* ``select`` — ``(stats, cfg, m) -> (weights [m], state | None)`` on
  [m]-sized inputs, followed by the weighted row combine; or
* ``column`` — ``(G [m, d], cfg, m) -> [d]`` for per-dimension rules.

Statistics and combines go through :mod:`..kernels.ops`: the CUDA
kernels for a CUDA G, the plain versions for a CPU G.  The elastic
``valid=`` path lands in a later slice and raises here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ..configs.base import ByzantineConfig
from ..kernels import ops, ref

STAT_NAMES = ref.STAT_NAMES


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

def leaf_stats(G, needs, m: int, valid=None) -> dict:
    """Partial statistics of the worker-major G [m, d] — one pass over
    G however many statistics the spec declared."""
    if valid is not None:
        raise NotImplementedError("the elastic valid= statistics are not "
                                  "ported yet")
    if not needs:
        return {}
    return ops.fused_stats(G, tuple(sorted(needs)))


def resolve_select(spec, stats: dict, cfg, m: int, device):
    """Run a spec's select rule and resolve the combine denominator:
    ``(weights [m] on device, state, denom)`` with the empty-selection
    guard (Σw == 0 divides by 1) and a SelectionState when the rule has
    no richer state."""
    w, st = spec.select(stats, cfg, m)
    w = w.to(device)
    if st is None:
        st = SelectionState(w > 0, w)
    sw = w.sum()
    return w, st, torch.where(sw > 0, sw, torch.ones_like(sw))


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


def _ones_select(stats, cfg, m):
    return torch.ones((m,), dtype=torch.float32), None


def _brsgd_select_rule(stats, cfg, m):
    st = brsgd_select(stats["scores"], stats["l1"], cfg.beta, cfg.threshold)
    return st.selected.to(torch.float32), st


def _krum_f(cfg, m: int) -> int:
    return cfg.krum_f if cfg.krum_f > 0 else max(1, int(cfg.alpha * m))


def _krum_scores(gram, cfg, m: int):
    """Krum score_i = Σ of the m-f-2 smallest d²_ij, from the Gram
    matrix (d²_ij = S_ii + S_jj − 2 S_ij, self-distance +inf)."""
    diag = torch.diagonal(gram)
    d2 = diag[:, None] + diag[None, :] - 2.0 * gram
    d2 = d2 + torch.diag(torch.full((m,), float("inf"), device=gram.device))
    n_close = max(1, m - _krum_f(cfg, m) - 2)
    return torch.sort(d2, dim=1).values[:, :n_close].sum(dim=1)


def _krum_select(stats, cfg, m):
    score = _krum_scores(stats["gram"], cfg, m)
    w = torch.nn.functional.one_hot(torch.argmin(score), m)
    return w.to(torch.float32), None


def _median_column(G, cfg, m):
    return ops.cwise_median(G)


register(AggregatorSpec("mean", select=_ones_select))
register(AggregatorSpec("median", column=_median_column))
register(AggregatorSpec("krum", stats=frozenset({"gram"}),
                        select=_krum_select))
register(AggregatorSpec("brsgd", stats=frozenset({"scores", "l1"}),
                        select=_brsgd_select_rule))


# ---------------------------------------------------------------------------
# local executor — single-host G [m, d]
# ---------------------------------------------------------------------------

def _combine_rows(G, w):
    """Σ_i w_i g_i / Σ_i w_i, rows accumulated in order 0..m-1."""
    return ops.masked_mean(G, w)


def aggregate_local(G, cfg: ByzantineConfig, return_state: bool = False,
                    spec: AggregatorSpec | None = None, valid=None):
    """Run one aggregator on the worker-gradient matrix G [m, d] -> [d].

    brsgd takes the two-pass path: pass 1 emits only the [m] partials
    (scores, l1), pass 2 fuses selection with the masked mean — G is
    read twice and no [d]-sized intermediate is written."""
    if valid is not None:
        raise NotImplementedError("the elastic valid= aggregation is not "
                                  "ported yet")
    spec = spec or get_spec(cfg.aggregator)
    G = G.to(torch.float32).contiguous()
    m = G.shape[0]
    if spec.column is not None:
        out = spec.column(G, cfg, m)
        return (out, None) if return_state else out

    if spec.name == "brsgd":
        # thresholds resolved once; pass 2 recomputes the mask per block
        # and returns it as w, the state adds C1 and C2 for diagnostics
        scores, l1 = ops.brsgd_partials(G)
        kth, T = ref.brsgd_thresholds(scores, l1, cfg.beta, cfg.threshold)
        agg, w = ops.brsgd_select_mean(G, scores, l1, kth, T)
        if not return_state:
            return agg
        _, c1, c2 = ref.brsgd_masks(scores, l1, kth, T)
        return agg, BrSGDState(w > 0, c1, c2, scores, l1, T)

    stats = leaf_stats(G, spec.stats, m)
    w, st, _denom = resolve_select(spec, stats, cfg, m, G.device)
    agg = _combine_rows(G, w)
    return (agg, st) if return_state else agg
