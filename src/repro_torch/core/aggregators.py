"""Robust gradient aggregation rules on G ∈ R^{m×d}: ``brsgd`` (paper
Algorithm 2) and the baselines ``mean``, ``cwise_median``,
``trimmed_mean`` (Yin et al. 2018), ``krum``, ``multi_krum`` (Blanchard
et al. 2017) and ``geometric_median`` (Chen et al. 2017).  Each is a
thin wrapper over :func:`.engine.aggregate_local`; all return the
aggregated gradient [d] on G's device."""
from __future__ import annotations

from ..configs.base import ByzantineConfig
from . import engine
from .engine import BrSGDState, brsgd_select  # noqa: F401  (public API)

_DEFAULT = ByzantineConfig()


def brsgd(G, cfg: ByzantineConfig, return_state: bool = False):
    """Paper Algorithm 2: 𝒜_{β,𝔗}({g^i})."""
    return engine.aggregate_local(G, cfg, return_state=return_state,
                                  spec=engine.get_spec("brsgd"))


def mean(G, cfg: ByzantineConfig = None):
    """Arithmetic mean (non-robust baseline), rows summed in order."""
    return engine.aggregate_local(G, cfg or _DEFAULT,
                                  spec=engine.get_spec("mean"))


def cwise_median(G, cfg: ByzantineConfig = None):
    return engine.aggregate_local(G, cfg or _DEFAULT,
                                  spec=engine.get_spec("median"))


def trimmed_mean(G, cfg: ByzantineConfig):
    """Coordinate-wise trimmed mean: drop the k = ⌊trim_frac·m⌋
    smallest and largest values of every column, average the rest."""
    return engine.aggregate_local(G, cfg,
                                  spec=engine.get_spec("trimmed_mean"))


def krum(G, cfg: ByzantineConfig):
    """Krum (Blanchard et al. 2017): the gradient whose summed squared
    distance to its m - f - 2 closest neighbours is minimal."""
    return engine.aggregate_local(G, cfg, spec=engine.get_spec("krum"))


def multi_krum(G, cfg: ByzantineConfig, n_select: int = 0):
    """Multi-Krum: the mean of the n_select rows with the best Krum
    scores (n_select defaults to m - f)."""
    spec = (engine.spec_with("multi_krum", n_select=n_select)
            if n_select else engine.get_spec("multi_krum"))
    return engine.aggregate_local(G, cfg, spec=spec)


def geometric_median(G, cfg: ByzantineConfig = None,
                     iters: int = engine.GEOMEDIAN_ITERS,
                     eps: float = engine.GEOMEDIAN_EPS):
    """Geometric median by Weiszfeld iterations in weight space, started
    at the coordinate-wise median (``engine._geomedian_select``)."""
    spec = engine.spec_with("geomedian", iters=iters, eps=eps)
    return engine.aggregate_local(G, cfg or _DEFAULT, spec=spec)


AGGREGATORS = {
    "mean": mean,
    "median": cwise_median,
    "trimmed_mean": trimmed_mean,
    "krum": krum,
    "multi_krum": multi_krum,
    "geomedian": geometric_median,
    "brsgd": brsgd,
}


def aggregate(G, cfg: ByzantineConfig):
    """Dispatch on cfg.aggregator.  G: [m, d] -> [d]."""
    return AGGREGATORS[cfg.aggregator](G, cfg)
