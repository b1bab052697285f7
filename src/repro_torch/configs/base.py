"""Config dataclasses of the port (a copy of the JAX package's
``ByzantineConfig`` — the port imports nothing of ``repro``)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ByzantineConfig:
    """Robust-aggregation config — the paper's technique knobs."""

    # any rule registered in core.engine: brsgd | mean | median |
    # trimmed_mean | krum | multi_krum | geomedian
    aggregator: str = "brsgd"
    beta: float = 0.5             # kept fraction (paper: beta = 1/2)
    threshold: float = 0.0        # 𝔗; 0.0 = auto (lower quartile of l1)
    trim_frac: float = 0.1        # trimmed_mean only
    krum_f: int = 0               # assumed byzantine count for krum; 0=auto
    # ------------------------------------------------------------------
    # threat model (training-time fault injection for experiments).
    # attack: "none" or any spec registered in core.threat.
    attack: str = "none"
    alpha: float = 0.0            # fraction of byzantine workers
    # membership policy — WHICH ⌊αm⌋ workers are byzantine:
    #   "prefix"   workers 0..⌊αm⌋-1 (the paper's arbitrary-identity set)
    #   "random"   fixed random subset drawn once from byz_seed
    #   "resample" fresh subset every step (drawn from the step key)
    membership: str = "prefix"
    byz_seed: int = 0             # membership="random" draw seed
    gaussian_std: float = 200.0   # gaussian: noise std (paper: 200)
    scale_factor: float = 1e10    # scale: multiplier on own gradient
    negation_factor: float = 1e10  # negation: c in -c * Σ honest
    alie_z: float = 1.5           # alie: z std-devs from honest mean
    ipm_eps: float = 0.5          # ipm: ε in -ε * mean(honest)
    # ------------------------------------------------------------------
    # elastic worker set (quorum aggregation).  0/0 = the classic fixed-m
    # bulk-synchronous round over every worker.
    max_m: int = 0
    quorum: int = 0

    def __post_init__(self):
        if self.max_m < 0 or self.quorum < 0:
            raise ValueError(
                f"max_m/quorum must be >= 0, got max_m={self.max_m} "
                f"quorum={self.quorum}")
        if self.max_m and self.quorum > self.max_m:
            raise ValueError(
                f"quorum={self.quorum} exceeds max_m={self.max_m} worker "
                f"slots")
        if self.quorum:
            # the adversary controls floor(alpha * n_active) of whichever
            # workers make the round, so the smallest round the config
            # permits must still hold an honest majority
            n_byz = int(self.alpha * self.quorum)
            if self.quorum <= 2 * n_byz:
                raise ValueError(
                    f"quorum={self.quorum} violates the honest-majority "
                    f"bound quorum > 2*n_byzantine: with alpha="
                    f"{self.alpha}, a {self.quorum}-worker round has "
                    f"n_byzantine = floor(alpha*quorum) = {n_byz} and "
                    f"2*{n_byz} >= {self.quorum} — robust selection over "
                    f"a possibly-byzantine-majority quorum is unsound; "
                    f"raise quorum or lower alpha")

    @property
    def elastic(self) -> bool:
        """True when this config opts into the elastic worker set
        (pad-to-max-m + validity mask + quorum select)."""
        return bool(self.max_m or self.quorum)
