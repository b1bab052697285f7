"""Threat model: the AttackSpec registry and the dense executor.

Port of the JAX package's ``core/threat.py`` for the single-host loop.
An :class:`AttackSpec` declares its ``scope`` (``"gradient"`` corrupts
worker-gradient values, ``"data"`` corrupts byzantine workers' labels in
the pipeline, ``"timing"`` delays their arrival in an elastic round),
the honest statistics it ``knows`` (``hsum`` Σ g_i and ``hsqsum`` Σ g_i²
over honest workers, per coordinate) and a pure rule.

Membership: ``"prefix"`` (workers 0..⌊αm⌋-1, the paper's setting),
``"random"`` (a fixed subset drawn once from ``cfg.byz_seed``) and
``"resample"`` (a fresh subset per step, from the step's generator).
Draws come from ``torch.Generator``s; their bits differ from
``jax.random``'s, so the keyed policies and gaussian noise agree with
the JAX package in distribution only.

Executors: ``apply_dense_`` / ``apply_dense`` on the single-host G
[m, d], and ``inject`` on one rank's gradient leaves across a rank mesh
(``launch.mesh``; the global scope with one rank a worker), its honest
knowledge all-reduced over the worker group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..configs.base import ByzantineConfig
from ..models import params as PM
from . import collectives

KNOWLEDGE = ("hsum", "hsqsum")
MEMBERSHIP_POLICIES = ("prefix", "random", "resample")

# domain-separates a step's membership draw from its other seeds
_MEMBERSHIP_TAG = 0x6279_7A6D  # "byzm"


# ---------------------------------------------------------------------------
# byzantine membership
# ---------------------------------------------------------------------------

def n_byzantine(cfg: ByzantineConfig, m: int, n_active=None):
    """⌊αm⌋ — every policy corrupts exactly this many workers.  With
    ``n_active`` (a tensor, elastic rounds) it is ⌊α·n_active⌋ of the
    workers that made the round, the product taken in float32 as the
    JAX package takes it."""
    if n_active is None:
        return int(cfg.alpha * m)
    return (cfg.alpha * n_active.to(torch.float32)).to(torch.int64)


def _membership_generator(cfg: ByzantineConfig, generator_or_step):
    """The generator the keyed policies draw from: ``byz_seed``'s for
    "random"; for "resample" the step's generator, or one seeded from
    (byz_seed, step) when a step index is given."""
    if cfg.membership == "random":
        return torch.Generator().manual_seed(cfg.byz_seed)
    if cfg.membership != "resample":
        raise ValueError(f"unknown membership policy {cfg.membership!r}; "
                         f"choose from {MEMBERSHIP_POLICIES}")
    if generator_or_step is None:
        raise ValueError("membership='resample' needs the step's generator "
                         "or step index")
    if isinstance(generator_or_step, torch.Generator):
        return generator_or_step
    seed = np.random.SeedSequence(
        [cfg.byz_seed, int(generator_or_step), _MEMBERSHIP_TAG])
    return torch.Generator().manual_seed(int(seed.generate_state(1)[0]))


def membership_mask(cfg: ByzantineConfig, m: int, generator_or_step=None,
                    active=None, device=None):
    """[m] bool — which workers are byzantine under ``cfg.membership``,
    on ``device`` (default: ``active``'s device, else the CPU).

    ``generator_or_step`` is read by "resample" only.  ``active`` ([m]
    0/1, elastic rounds) restricts the draw to the active workers:
    ⌊α·n_active⌋ byzantines, all of them active — "prefix" takes the
    first that many active slots, the keyed policies rank the active
    slots by a random priority (dropped slots +inf, never drawn)."""
    if device is None:
        device = active.device if active is not None else "cpu"
    if active is not None:
        v = active.to(device) > 0
        nb = n_byzantine(cfg, m, v.sum())
        if cfg.membership == "prefix":
            return v & (torch.cumsum(v.to(torch.int64), 0) <= nb)
        gen = _membership_generator(cfg, generator_or_step)
        u = torch.rand(m, generator=gen, device=gen.device).to(device)
        prio = torch.where(v, u, float("inf"))
        rank = (prio[None, :] < prio[:, None]).sum(dim=1)
        return v & (rank < nb)
    n_byz = n_byzantine(cfg, m)
    if cfg.membership == "prefix" or n_byz == 0:
        return torch.arange(m, device=device) < n_byz
    gen = _membership_generator(cfg, generator_or_step)
    perm = torch.randperm(m, generator=gen, device=gen.device).to(device)
    mask = torch.zeros(m, dtype=torch.bool, device=device)
    mask[perm[:n_byz]] = True
    return mask


def data_membership(cfg: ByzantineConfig, m: int, step: int = 0) -> np.ndarray:
    """NumPy-side membership mask for the pipelines, which have no step
    generator: "resample" draws from (byz_seed, step) instead."""
    return membership_mask(cfg, m, step).numpy()


# ---------------------------------------------------------------------------
# attack registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AttackSpec:
    """Scope-independent description of one Byzantine attack."""
    name: str
    scope: str = "gradient"             # "gradient" | "data" | "timing"
    knows: frozenset = frozenset()      # honest stats the rule reads
    corrupt: Optional[Callable] = None  # (g, know, gen, cfg) -> evil
    corrupt_labels: Optional[Callable] = None  # (y, n_classes) -> y'
    # timing-scope rule on one elastic round's per-worker arrival delays
    # (numpy [m], +inf = never arrives): (delays, is_byz, cfg) -> delays'.
    # Run by data.pipeline.ArrivalSchedule; gradients stay untouched.
    delay: Optional[Callable] = None
    # worker-independent rule: every byzantine worker emits the same
    # row, computed once and broadcast
    shared_row: bool = False

    def __post_init__(self):
        if self.scope not in ("gradient", "data", "timing"):
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
        if (self.scope == "timing") != (self.delay is not None):
            raise ValueError(f"{self.name}: timing specs set delay, other "
                             f"scopes don't")
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
    """Replace byzantine values with N(0, std²) noise (paper: std=200).

    On a model-sharded view of a leaf the sharded executor passes the
    leaf's global shape and this shard's slices (``noise_shape`` /
    ``noise_slices``, :func:`inject`): the noise is drawn for the whole
    leaf and sliced, so it does not depend on the model sharding."""
    shape = know.get("noise_shape", tuple(g.shape))
    noise = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=g.device)
    if "noise_slices" in know:
        noise = noise[know["noise_slices"]]
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
# byzantine workers stall (never arrive): an elastic round's quorum fills
# from honest workers, or runs short-handed; no gradient is corrupted
register(AttackSpec("stall", scope="timing",
                    delay=lambda d, is_byz, cfg: np.where(is_byz, np.inf, d)))


def is_gradient_attack(cfg: ByzantineConfig) -> bool:
    """True when cfg names a gradient-scope attack that fires (alpha > 0)."""
    if cfg.attack == "none" or cfg.alpha <= 0:
        return False
    return get_spec(cfg.attack).scope == "gradient"


# columns an in-place attack reads at a time (the knowledge rules' honest
# moments and their evil row): [m, KNOWLEDGE_BLOCK] floats of temporaries,
# not [m, d]; at or below one block the moments are the whole-G sums
KNOWLEDGE_BLOCK = 1 << 22


def _dense_knowledge(G, mask, knows, n_honest, active=None) -> dict:
    """Honest per-coordinate moments from the [m, d] matrix (or a column
    block of it).  In an elastic round the dropped workers are excluded
    too: the adversary reads only gradients that were produced.
    ``n_honest`` rides along as a float32 tensor on G's device, so the
    rules divide by it with IEEE division on the card too."""
    know = {}
    if knows:
        drop = mask if active is None else (mask | ~(active > 0))
        keep = torch.where(drop[:, None], torch.zeros_like(G),
                           G.to(torch.float32))
        if "hsum" in knows:
            know["hsum"] = keep.sum(dim=0)
        if "hsqsum" in knows:
            know["hsqsum"] = (keep * keep).sum(dim=0)
        know["n_honest"] = torch.as_tensor(n_honest, dtype=torch.float32,
                                           device=G.device)
    return know


def _column_blocks(d: int, block: int):
    return [(a, min(a + block, d)) for a in range(0, d, block)]


def step_membership(cfg: ByzantineConfig, m: int, generator, active=None,
                    device=None):
    """The [m] byzantine mask of one step, drawn once (from ``generator``
    under "resample"; over the active set in an elastic round), or None
    when no gradient attack fires: the blocked scope hands it to every
    bucket's :func:`apply_dense_` so that all buckets corrupt the same
    workers, as the reference's ``membership_key`` does."""
    if not is_gradient_attack(cfg):
        return None
    if active is None:
        if n_byzantine(cfg, m) == 0:
            return None
        return membership_mask(cfg, m, generator, device=device)
    return membership_mask(cfg, m, generator,
                           active=torch.as_tensor(active).to(device))


def apply_dense_(G, generator, cfg: ByzantineConfig, active=None,
                 membership=None):
    """Corrupt the byzantine rows of the dense worker-gradient matrix
    G [m, d] in place and return G.  Data- and timing-scope attacks and
    alpha=0 leave G as it is (data corruption happens in the pipeline,
    arrival timing in the ArrivalSchedule).  ``generator`` (a
    ``torch.Generator`` on G's device) drives gaussian noise and
    "resample" membership.  ``active`` ([m] 0/1) scopes an elastic
    round: membership and knowledge are drawn over the active set only.
    ``membership`` ([m] bool, :func:`step_membership`) gives the
    byzantine set instead of drawing it: the bucket form of the
    reference's ``inject``, whose noise and membership have keys of
    their own.

    No [m, d] temporary is made: the honest moments of a knowledge rule
    are taken over blocks of :data:`KNOWLEDGE_BLOCK` columns, and its evil row
    written block by block into the first byzantine row, then copied to
    the others (every shipped knowledge rule is a shared-row rule); any
    other rule corrupts one byzantine row at a time, in row order, so
    gaussian noise is drawn row by row into G."""
    if not is_gradient_attack(cfg):
        return G
    spec = get_spec(cfg.attack)
    m, d = G.shape
    if active is None:
        n_byz = n_byzantine(cfg, m)
        if n_byz == 0:
            return G
        mask = (membership_mask(cfg, m, generator, device=G.device)
                if membership is None else membership.to(G.device))
        n_honest = m - n_byz
    else:
        active = torch.as_tensor(active).to(G.device)
        na = (active > 0).sum()
        mask = (membership_mask(cfg, m, generator, active=active)
                if membership is None else membership.to(G.device))
        n_honest = na - n_byzantine(cfg, m, na)
    rows = torch.nonzero(mask).flatten().tolist()
    if not rows:
        return G
    if spec.shared_row:
        first = G[rows[0]]
        for a, b in _column_blocks(d, KNOWLEDGE_BLOCK):
            know = _dense_knowledge(G[:, a:b], mask, spec.knows, n_honest,
                                    active)
            evil = spec.corrupt(G[0, a:b], know, generator, cfg)
            first[a:b] = evil.to(G.dtype)
        for r in rows[1:]:
            G[r].copy_(first)
        return G
    know = {}
    if spec.knows:
        parts = [_dense_knowledge(G[:, a:b], mask, spec.knows, n_honest,
                                  active)
                 for a, b in _column_blocks(d, KNOWLEDGE_BLOCK)]
        know = {k: torch.cat([p[k] for p in parts]) for k in spec.knows}
        know["n_honest"] = parts[0]["n_honest"]
    for r in rows:
        evil = spec.corrupt(G[r:r + 1], know, generator, cfg)
        G[r].copy_(evil[0].to(G.dtype))
    return G


def apply_dense(G, generator, cfg: ByzantineConfig, active=None):
    """:func:`apply_dense_` on a copy of G: the corrupted matrix, G left
    as it was (G itself when no attack fires: no gradient attack, or no
    byzantine worker in a fixed round)."""
    if not is_gradient_attack(cfg) or (
            active is None and n_byzantine(cfg, G.shape[0]) == 0):
        return G
    return apply_dense_(G.clone(), generator, cfg, active)


# ---------------------------------------------------------------------------
# the sharded executor: one rank a worker (and model shard)
# ---------------------------------------------------------------------------

def inject_collectives(cfg: ByzantineConfig, n_leaves: int,
                       m: Optional[int] = None) -> dict:
    """Per-call collectives of :func:`inject`: an all-reduce per declared
    knowledge entry per leaf for an omniscient attack, none for the
    others.  ``axis_index`` counts the worker index read (the reference's
    one collective of that name; here the rank's coordinate, no
    communication)."""
    if not is_gradient_attack(cfg) or (m is not None
                                       and n_byzantine(cfg, m) == 0):
        return {"all_reduce": 0, "axis_index": 0}
    knows = len(get_spec(cfg.attack).knows)
    return {"all_reduce": knows * n_leaves, "axis_index": 1}


def _sharded_knowledge(g, drop: bool, knows, mesh, axes, n_honest) -> dict:
    """The honest moments across ranks: this worker's leaf, or exact
    zeros where it is byzantine (or inactive), all-reduced over the
    worker axes."""
    know = {}
    if knows:
        keep = (torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                if drop else g.to(torch.float32).clone())
        if "hsqsum" in knows:
            know["hsqsum"] = collectives.all_reduce(keep * keep, mesh, axes)
        if "hsum" in knows:
            know["hsum"] = collectives.all_reduce(keep, mesh, axes)
        know["n_honest"] = torch.as_tensor(n_honest, dtype=torch.float32,
                                           device=g.device)
    return know


def leaf_generator(seed: int, worker: int, leaf: int,
                   device) -> torch.Generator:
    """The noise generator of one (worker, leaf) of a step: seeded from
    the step's seed and the two indices, so a worker's noise for a leaf
    is the same on every mesh (the reference's ``_leaf_key``)."""
    s = np.random.SeedSequence([int(seed), int(worker), int(leaf)])
    return torch.Generator(device=device).manual_seed(
        int(s.generate_state(1)[0]))


def _noise_view(g, pspec, mesh, model_axes):
    """(global shape, slices) of this rank's view of a leaf sharded over
    ``model_axes``, or None when it is replicated over them."""
    if pspec is None or not model_axes:
        return None
    spec = []
    for dim in range(g.dim()):
        entry = pspec[dim] if dim < len(pspec) else None
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        names = tuple(a for a in names if a in model_axes)
        spec.append(names or None)
    if all(e is None for e in spec):
        return None
    shape = tuple(n if e is None else n * mesh.size(e)
                  for n, e in zip(g.shape, spec))
    return shape, PM.shard_view(shape, spec, mesh)


def inject(grads, key, cfg: ByzantineConfig, mesh, axes, membership=None,
           leaf_specs=None, model_axes=(), active=None):
    """Corrupt this rank's gradient leaves (a nested dict in sorted-key
    order, or a list) when its worker is byzantine; the global scope's
    attack before ``robust_aggregate``.  Returns the same structure; an
    honest worker's leaves are returned as they are.

    ``key`` is the step's generator (or its seed): "resample" draws the
    membership from it, and gaussian noise comes from one generator a
    (worker, leaf), seeded from its ``initial_seed``
    (:func:`leaf_generator`).  ``membership`` ([m] bool) gives the
    byzantine set instead of drawing it.  Knowledge (``hsum``,
    ``hsqsum``) is all-reduced over the worker axes, one all-reduce per
    entry and leaf.  ``leaf_specs`` / ``model_axes``: a model-sharded
    leaf is this rank's shard; its noise is drawn for the whole leaf and
    sliced, so it does not depend on the model sharding.  ``active``
    ([m] 0/1, elastic rounds): membership and knowledge over the active
    workers only; an inactive worker is never corrupted."""
    if not is_gradient_attack(cfg):
        return grads
    spec = get_spec(cfg.attack)
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    m, idx = mesh.size(axes), mesh.index(axes)
    leaves, rebuild = PM.tree_flatten(grads)
    dev = leaves[0].device
    gen = key if isinstance(key, torch.Generator) else None
    seed = key.initial_seed() if gen is not None else int(key)
    if active is None:
        n_byz = n_byzantine(cfg, m)
        if n_byz == 0:
            return grads
        mask = (membership_mask(cfg, m, gen if gen is not None else seed,
                                device=dev)
                if membership is None else membership.to(dev))
        n_honest, is_active = m - n_byz, True
    else:
        act = torch.as_tensor(active).to(device=dev, dtype=torch.float32)
        na = (act > 0).sum()
        mask = (membership_mask(cfg, m, gen if gen is not None else seed,
                                active=act)
                if membership is None else membership.to(dev))
        n_honest = na - n_byzantine(cfg, m, na)
        is_active = bool(act[idx] > 0)
    is_byz = bool(mask[idx])
    spec_leaves = ([None] * len(leaves) if leaf_specs is None
                   else PM.tree_flatten(leaf_specs)[0])
    out = []
    for li, (g, ps) in enumerate(zip(leaves, spec_leaves)):
        know = _sharded_knowledge(g, is_byz or not is_active, spec.knows,
                                  mesh, axes, n_honest)
        if not is_byz:
            out.append(g)
            continue
        view = _noise_view(g, ps, mesh, tuple(model_axes))
        if view is not None:
            know["noise_shape"], know["noise_slices"] = view
        evil = spec.corrupt(g, know, leaf_generator(seed, idx, li, dev), cfg)
        out.append(evil.to(g.dtype).reshape(g.shape))
    return rebuild(out)
