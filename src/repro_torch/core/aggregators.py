"""Robust gradient aggregation rules on G ∈ R^{m×d}: ``brsgd`` (paper
Algorithm 2) and the baselines ``mean``, ``cwise_median`` and ``krum``.
Each is a thin wrapper over :func:`.engine.aggregate_local`; all return
the aggregated gradient [d] on G's device."""
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


def krum(G, cfg: ByzantineConfig):
    """Krum (Blanchard et al. 2017): the gradient whose summed squared
    distance to its m - f - 2 closest neighbours is minimal."""
    return engine.aggregate_local(G, cfg, spec=engine.get_spec("krum"))


AGGREGATORS = {
    "mean": mean,
    "median": cwise_median,
    "krum": krum,
    "brsgd": brsgd,
}


def aggregate(G, cfg: ByzantineConfig):
    """Dispatch on cfg.aggregator.  G: [m, d] -> [d]."""
    return AGGREGATORS[cfg.aggregator](G, cfg)
