"""Shared harness of the paper-repro runs (twin of the JAX package's
``benchmarks/common.py``)."""
from __future__ import annotations

import math

import torch

from .. import resolve_device
from ..configs.base import ByzantineConfig
from ..configs.lenet_fmnist import LeNetConfig
from ..core.simulate import make_sim_step
from ..data.pipeline import ImageWorkerPipeline
from ..models import lenet
from ..models.params import init_params

M = 20   # paper: 20 workers


def train_lenet(aggregator: str, attack: str, alpha: float, steps: int = 60,
                lr: float = 0.05, seed: int = 0, batch: int = 8,
                record_every: int = 5, device="cuda"):
    """One paper-style run on ``device``.  Returns (final_acc,
    curve[(step, acc)]); a run whose parameters went non-finite reports
    accuracy nan."""
    dev = resolve_device(device)
    cfg = LeNetConfig()
    bcfg = ByzantineConfig(aggregator=aggregator, attack=attack, alpha=alpha)
    pipe = ImageWorkerPipeline(M, n_per_worker=128, seed=seed, byz=bcfg)
    init_gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(lenet.lenet_defs(cfg), init_gen, device=dev)
    step_fn = make_sim_step(lenet.lenet_loss, bcfg, lr, device=dev)
    noise_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    test_x = torch.as_tensor(pipe.test_images[:512], device=dev)
    test_y = torch.as_tensor(pipe.test_labels[:512], device=dev)
    curve = []
    for s in range(steps):
        params, _ = step_fn(params, pipe.batch(s, batch), noise_gen)
        if s % record_every == 0 or s == steps - 1:
            acc = float(lenet.lenet_accuracy(params, test_x, test_y))
            first = params[sorted(params)[0]]
            if not math.isfinite(float(first.sum())):
                acc = float("nan")
            curve.append((s, acc))
    return curve[-1][1], curve
