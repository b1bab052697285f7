"""Threat model: the AttackSpec registry and the dense executor.

Port of the JAX package's ``core/threat.py`` for the single-host loop.
An :class:`AttackSpec` declares its ``scope`` (``"gradient"`` corrupts
worker-gradient values, ``"data"`` corrupts byzantine workers' labels in
the pipeline), the honest statistics it ``knows`` (``hsum`` Σ g_i and
``hsqsum`` Σ g_i² over honest workers, per coordinate) and a pure rule.

Membership: ``"prefix"`` (workers 0..⌊αm⌋-1, the paper's setting).  The
keyed ``"random"`` and ``"resample"`` policies are not ported yet and
raise.  Gaussian noise is drawn from a ``torch.Generator``; its bits
differ from ``jax.random``'s, so parity with the JAX package holds for
the noise only in distribution.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..configs.base import ByzantineConfig

KNOWLEDGE = ("hsum", "hsqsum")
MEMBERSHIP_POLICIES = ("prefix", "random", "resample")


# ---------------------------------------------------------------------------
# byzantine membership
# ---------------------------------------------------------------------------

def n_byzantine(cfg: ByzantineConfig, m: int) -> int:
    """⌊αm⌋ — every policy corrupts exactly this many workers."""
    return int(cfg.alpha * m)


def membership_mask(cfg: ByzantineConfig, m: int, device="cpu"):
    """[m] bool — which workers are byzantine under ``cfg.membership``."""
    n_byz = n_byzantine(cfg, m)
    if cfg.membership == "prefix" or n_byz == 0:
        return torch.arange(m, device=device) < n_byz
    if cfg.membership in MEMBERSHIP_POLICIES:
        raise NotImplementedError(f"membership={cfg.membership!r} is not "
                                  f"ported yet; use 'prefix'")
    raise ValueError(f"unknown membership policy {cfg.membership!r}; "
                     f"choose from {MEMBERSHIP_POLICIES}")


def data_membership(cfg: ByzantineConfig, m: int, step: int = 0) -> np.ndarray:
    """NumPy-side membership mask for data-scope corruption."""
    return membership_mask(cfg, m).numpy()


# ---------------------------------------------------------------------------
# attack registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AttackSpec:
    """Scope-independent description of one Byzantine attack."""
    name: str
    scope: str = "gradient"             # "gradient" | "data"
    knows: frozenset = frozenset()      # honest stats the rule reads
    corrupt: Optional[Callable] = None  # (g, know, gen, cfg) -> evil
    corrupt_labels: Optional[Callable] = None  # (y, n_classes) -> y'
    # worker-independent rule: every byzantine worker emits the same
    # row, computed once and broadcast
    shared_row: bool = False

    def __post_init__(self):
        if self.scope not in ("gradient", "data"):
            raise ValueError(f"{self.name}: unknown scope {self.scope!r}")
        if self.shared_row and self.scope != "gradient":
            raise ValueError(f"{self.name}: shared_row is a gradient-scope "
                             f"property")
        if (self.scope == "gradient") != (self.corrupt is not None):
            raise ValueError(f"{self.name}: gradient specs set corrupt, "
                             f"other scopes don't")
        if (self.scope == "data") != (self.corrupt_labels is not None):
            raise ValueError(f"{self.name}: data specs set corrupt_labels, "
                             f"other scopes don't")
        unknown = set(self.knows) - set(KNOWLEDGE)
        if unknown:
            raise ValueError(f"{self.name}: unknown knowledge "
                             f"{sorted(unknown)}")


_REGISTRY: dict[str, AttackSpec] = {}


def register(spec: AttackSpec) -> AttackSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_spec(name: str) -> AttackSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown attack {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def registered() -> tuple:
    return tuple(sorted(_REGISTRY))


# ---- corruption rules (paper §5.1 + literature) ----------------------------
# g is the byzantine rows [n, d] (or one row for shared-row rules)

def _gaussian(g, know, gen, cfg):
    """Replace byzantine values with N(0, std²) noise (paper: std=200)."""
    noise = torch.randn(g.shape, generator=gen, dtype=torch.float32,
                        device=g.device)
    return noise * cfg.gaussian_std


def _negation(g, know, gen, cfg):
    """Model Negation: -(sum of honest gradients) * c."""
    return -cfg.negation_factor * know["hsum"]


def _scale(g, know, gen, cfg):
    """Gradient Scale: own gradient scaled by a large constant."""
    return g.to(torch.float32) * cfg.scale_factor


def _sign_flip(g, know, gen, cfg):
    """Byzantine workers negate their gradient."""
    return -g.to(torch.float32)


def _alie(g, know, gen, cfg):
    """ALIE (Baruch et al., 2019): z standard deviations from the honest
    mean, per coordinate."""
    n = know["n_honest"]
    mu = know["hsum"] / n
    var = torch.clamp(know["hsqsum"] / n - mu * mu, min=0.0)
    return mu - cfg.alie_z * torch.sqrt(var)


def _ipm(g, know, gen, cfg):
    """IPM (Xie et al., 2020): -ε·mean(honest)."""
    return -cfg.ipm_eps * (know["hsum"] / know["n_honest"])


register(AttackSpec("gaussian", corrupt=_gaussian))
register(AttackSpec("negation", knows=frozenset({"hsum"}),
                    corrupt=_negation, shared_row=True))
register(AttackSpec("scale", corrupt=_scale))
register(AttackSpec("sign_flip", corrupt=_sign_flip))
register(AttackSpec("alie", knows=frozenset({"hsum", "hsqsum"}),
                    corrupt=_alie, shared_row=True))
register(AttackSpec("ipm", knows=frozenset({"hsum"}), corrupt=_ipm,
                    shared_row=True))
# the paper's Label Shift: y -> (n_classes - 1) - y on byzantine shards
register(AttackSpec("label_flip", scope="data",
                    corrupt_labels=lambda y, n_classes: n_classes - 1 - y))


def is_gradient_attack(cfg: ByzantineConfig) -> bool:
    """True when cfg names a gradient-scope attack that fires (alpha > 0)."""
    if cfg.attack == "none" or cfg.alpha <= 0:
        return False
    return get_spec(cfg.attack).scope == "gradient"


def _dense_knowledge(G, mask, knows, n_honest: int) -> dict:
    """Honest per-coordinate moments from the full [m, d] matrix."""
    know = {}
    if knows:
        keep = torch.where(mask[:, None], torch.zeros_like(G),
                           G.to(torch.float32))
        if "hsum" in knows:
            know["hsum"] = keep.sum(dim=0)
        if "hsqsum" in knows:
            know["hsqsum"] = (keep * keep).sum(dim=0)
        know["n_honest"] = float(n_honest)
    return know


def apply_dense(G, generator, cfg: ByzantineConfig):
    """Corrupt the byzantine rows of the dense worker-gradient matrix
    G [m, d].  Data-scope attacks and alpha=0 are no-ops here (data
    corruption happens in the pipeline).  ``generator`` (a
    ``torch.Generator`` on G's device) drives key-driven rules
    (gaussian); deterministic rules ignore it."""
    if not is_gradient_attack(cfg):
        return G
    spec = get_spec(cfg.attack)
    m = G.shape[0]
    n_byz = n_byzantine(cfg, m)
    if n_byz == 0:
        return G
    mask = membership_mask(cfg, m, G.device)
    know = _dense_knowledge(G, mask, spec.knows, m - n_byz)
    if spec.shared_row:
        evil = spec.corrupt(G[0], know, generator, cfg)[None]
    else:
        evil = torch.zeros_like(G, dtype=torch.float32)
        evil[mask] = spec.corrupt(G[mask], know, generator, cfg)
    return torch.where(mask[:, None], evil.to(G.dtype), G)
