"""Synthetic FashionMNIST-geometry image set (numpy; a copy of the JAX
package's generator so the same seed gives the same bits)."""
from __future__ import annotations

import numpy as np


def fmnist_like(n: int, seed: int = 0, image_size: int = 28, n_classes: int = 10,
                template_seed: int = 1234):
    """Class-conditional synthetic image set: (images [n,28,28,1] in
    [0,1], labels [n]).  Each class has a fixed random low-frequency
    template + per-sample noise.  The class templates come from
    ``template_seed`` (fixed by default) so train/test splits drawn with
    different ``seed`` values share one underlying distribution."""
    trng = np.random.default_rng(template_seed)
    rng = np.random.default_rng(seed)
    # low-frequency class templates: random 7x7 upsampled to 28x28
    base = trng.normal(0, 1, size=(n_classes, 7, 7))
    templates = np.kron(base, np.ones((4, 4)))               # [C,28,28]
    labels = rng.integers(0, n_classes, size=n)
    imgs = templates[labels] + rng.normal(0, 0.7, size=(n, image_size, image_size))
    imgs = 1.0 / (1.0 + np.exp(-imgs))                       # squash to (0,1)
    return imgs[..., None].astype(np.float32), labels.astype(np.int32)
