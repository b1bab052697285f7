"""Synthetic data sources (numpy; copies of the JAX package's
generators, so the same seed gives the same bits).

* ``TokenStream``: a deterministic pseudo-corpus of token sequences, a
  noisy bigram chain, for LM training.
* ``fmnist_like``: a FashionMNIST-geometry image set for the LeNet
  repro.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    """Deterministic synthetic LM corpus: next = (cur * mult + 1) mod V
    with probability q, else uniform, so cross-entropy has a learnable
    floor well below log(V).  ``batch(step, batch, seq_len)`` draws from
    ``default_rng(seed * 1_000_003 + step)``."""

    def __init__(self, vocab: int, seed: int = 0, q: float = 0.8,
                 mult: int = 31):
        self.vocab = int(vocab)
        self.seed = seed
        self.q = q
        self.mult = mult

    def batch(self, step: int, batch: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        toks = np.empty((batch, seq_len), np.int32)
        cur = rng.integers(0, self.vocab, size=batch)
        toks[:, 0] = cur
        for t in range(1, seq_len):
            follow = rng.random(batch) < self.q
            nxt = (cur * self.mult + 1) % self.vocab
            rand = rng.integers(0, self.vocab, size=batch)
            cur = np.where(follow, nxt, rand)
            toks[:, t] = cur
        return toks


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
