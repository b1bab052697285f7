"""Per-worker batch pipeline for the LeNet repro.

Batches carry a leading worker axis [m, b, ...] (numpy).  Byzantine
*data* corruption happens here: a data-scope ``AttackSpec`` (label_flip)
applies its ``corrupt_labels`` rule to the byzantine workers' shards,
per ``batch(step)``, from the config's membership mask.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..configs.base import ByzantineConfig
from ..core import threat
from .synthetic import fmnist_like


def data_attack_spec(byz: Optional[ByzantineConfig]):
    """The active data-scope AttackSpec, or None (gradient-scope and
    attack-free configs corrupt nothing here)."""
    if byz is None or byz.attack == "none" or byz.alpha <= 0:
        return None
    spec = threat.get_spec(byz.attack)
    return spec if spec.scope == "data" else None


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
