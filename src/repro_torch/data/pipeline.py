"""Per-worker batch pipelines (token batches for LM training, images
for the LeNet repro), and the arrival schedule of elastic rounds.

Batches carry a leading worker axis [m, b, ...] (numpy).  Byzantine
*data* corruption happens here: a data-scope ``AttackSpec`` (label_flip)
applies its ``corrupt_labels`` rule to the byzantine workers' shards,
per ``batch(step)``, from the config's membership mask.  Arrival timing
of an elastic round happens here too (:class:`ArrivalSchedule`), where a
timing-scope spec (stall) rewrites the byzantine workers' delays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..configs.base import ByzantineConfig, ModelConfig
from ..core import threat
from .synthetic import TokenStream, fmnist_like


def _attack_spec(byz: Optional[ByzantineConfig], scope: str):
    if byz is None or byz.attack == "none" or byz.alpha <= 0:
        return None
    spec = threat.get_spec(byz.attack)
    return spec if spec.scope == scope else None


def data_attack_spec(byz: Optional[ByzantineConfig]):
    """The active data-scope AttackSpec, or None (gradient-scope and
    attack-free configs corrupt nothing here)."""
    return _attack_spec(byz, "data")


def timing_attack_spec(byz: Optional[ByzantineConfig]):
    """The active timing-scope AttackSpec (stall), or None.  Timing
    attacks act on the :class:`ArrivalSchedule`'s delays, not on data
    or gradients."""
    return _attack_spec(byz, "timing")


STRAGGLE_DISTS = ("none", "exp", "pareto")


def parse_straggle(arg: str) -> tuple:
    """Parse a ``dist[:scale]`` straggle argument into ``(dist, scale)``.
    ``none`` takes no scale; ``exp``/``pareto`` default to scale 1.0 and
    reject non-positive scales."""
    dist, sep, scale_s = str(arg).partition(":")
    if dist not in STRAGGLE_DISTS:
        raise ValueError(
            f"straggle distribution {dist!r}: choose from "
            f"{', '.join(STRAGGLE_DISTS)} (format: dist[:scale], "
            f"e.g. exp:0.5)")
    if not sep:
        return dist, 1.0
    if dist == "none":
        raise ValueError("straggle 'none' takes no scale")
    try:
        scale = float(scale_s)
    except ValueError:
        raise ValueError(
            f"straggle scale {scale_s!r} is not a number "
            f"(format: dist[:scale], e.g. pareto:2.0)") from None
    if not scale > 0:
        raise ValueError(f"straggle scale must be positive, got {scale}")
    return dist, scale


class ArrivalSchedule:
    """Per-step worker arrival delays and the quorum-selected active set.

    Each step draws an arrival delay per worker from ``straggle``
    (``none`` | ``exp`` | ``pareto``, times ``scale``), lets a
    timing-scope attack rewrite the byzantine workers' delays (``stall``
    pins them to +inf: they never arrive), and takes the first
    ``quorum`` workers to arrive as the round's active set.  Draws are
    keyed on ``(seed, step)``, so the schedule is reproducible and the
    same as the JAX package's.  ``active(step)`` is the [m] 0/1 float32
    mask; a worker with an infinite delay is never active, even when
    fewer than ``quorum`` arrive (the round then runs under quorum)."""

    def __init__(self, n_workers: int, quorum: int, straggle: str = "none",
                 scale: float = 1.0, byz: Optional[ByzantineConfig] = None,
                 seed: int = 0):
        if straggle not in STRAGGLE_DISTS:
            raise ValueError(f"straggle={straggle!r}: "
                             f"choose from {', '.join(STRAGGLE_DISTS)}")
        if not 0 < quorum <= n_workers:
            raise ValueError(f"quorum={quorum} out of range for "
                             f"{n_workers} workers")
        self.m, self.quorum = n_workers, quorum
        self.straggle, self.scale = straggle, scale
        self.byz, self.seed = byz, seed

    def delays(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        if self.straggle == "exp":
            d = rng.exponential(self.scale, self.m)
        elif self.straggle == "pareto":
            d = rng.pareto(2.0, self.m) * self.scale
        else:
            d = np.zeros(self.m)
        spec = timing_attack_spec(self.byz)
        if spec is not None:
            is_byz = threat.data_membership(self.byz, self.m, step)
            d = spec.delay(d, is_byz, self.byz)
        return d

    def active(self, step: int) -> np.ndarray:
        d = self.delays(step)
        order = np.argsort(d, kind="stable")
        act = np.zeros(self.m, np.float32)
        act[order[:self.quorum]] = 1.0
        return act * np.isfinite(d)


class LMWorkerPipeline:
    """Token batches [m, b, S] (int32, numpy) for LM training: one
    ``TokenStream`` draw of m·b sequences per step, split by worker.  A
    data-scope attack (label_flip) corrupts the byzantine workers' token
    streams, per ``batch(step)``, from the config's membership mask.
    Configs with a (stub) vision / audio frontend also get
    ``"prefix_embed"`` [m, b, P, d] float32, drawn as the JAX package
    draws it (``default_rng(step)``, normal(0, 0.02)): the same bits."""

    def __init__(self, cfg: ModelConfig, n_workers: int,
                 batch_per_worker: int, seq_len: int, seed: int = 0,
                 byz: Optional[ByzantineConfig] = None):
        self.cfg = cfg
        self.m = n_workers
        self.b = batch_per_worker
        self.seq = seq_len
        self.stream = TokenStream(cfg.vocab, seed=seed)
        self.byz = byz

    def batch(self, step: int) -> dict:
        toks = self.stream.batch(step, self.m * self.b, self.seq)
        toks = toks.reshape(self.m, self.b, self.seq)
        spec = data_attack_spec(self.byz)
        if spec is not None:
            mask = threat.data_membership(self.byz, self.m, step)
            toks[mask] = spec.corrupt_labels(toks[mask], self.cfg.vocab)
        out = {"tokens": toks}
        if self.cfg.n_prefix_tokens:
            out["prefix_embed"] = prefix_embeddings(
                self.cfg, step, (self.m, self.b))
        return out


def prefix_embeddings(cfg: ModelConfig, step: int, lead: tuple) -> np.ndarray:
    """The stub frontend's precomputed embeddings [*lead, P, d] float32
    of ``step``: ``default_rng(step).normal(0, 0.02)``, the JAX
    pipeline's draw."""
    rng = np.random.default_rng(step)
    return rng.normal(0, 0.02, size=(*lead, cfg.n_prefix_tokens,
                                     cfg.d_model)).astype(np.float32)


class ImageWorkerPipeline:
    """FashionMNIST-like shards: each worker owns n samples; byzantine
    workers' labels are corrupted per ``batch(step)`` by any data-scope
    attack.  The stored dataset stays clean."""

    def __init__(self, n_workers: int, n_per_worker: int, seed: int = 0,
                 byz: Optional[ByzantineConfig] = None, n_classes: int = 10):
        self.m, self.n = n_workers, n_per_worker
        self.byz, self.n_classes = byz, n_classes
        imgs, labels = fmnist_like(n_workers * n_per_worker, seed=seed)
        self.images = imgs.reshape(n_workers, n_per_worker, *imgs.shape[1:])
        self.labels = labels.reshape(n_workers, n_per_worker)
        self.test_images, self.test_labels = fmnist_like(2048, seed=seed + 777)

    def batch(self, step: int, batch_per_worker: int) -> dict:
        rng = np.random.default_rng(step)
        idx = rng.integers(0, self.n, size=(self.m, batch_per_worker))
        labels = np.stack([self.labels[w, idx[w]] for w in range(self.m)])
        spec = data_attack_spec(self.byz)
        if spec is not None:
            mask = threat.data_membership(self.byz, self.m, step)
            labels[mask] = spec.corrupt_labels(labels[mask], self.n_classes)
        return {
            "images": np.stack([self.images[w, idx[w]] for w in range(self.m)]),
            "labels": labels,
        }
