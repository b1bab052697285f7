"""Shared harness of the paper-repro runs (twin of the JAX package's
``benchmarks/common.py``): the LeNet loop of Table 1 / Fig. 3, and the
strongly convex regression of the rate, ablation and robustness runs."""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ByzantineConfig
from ..configs.lenet_fmnist import LeNetConfig
from ..core import aggregators, engine, threat
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


# the regression problem of benchmarks/{rate,ablation,robustness}.py
REG_D, REG_LR = 20, 0.3


def regression_problem(m: int, n: int, seed: int, dev):
    """(w* [D], X [m, n, D], y [m, n]) as the JAX benchmarks draw them.
    w* and y come out float64 (the f64 scalar sqrt(D) promotes); the JAX
    package rounds them to float32 on the way in, and so does this."""
    rng = np.random.default_rng(seed)
    w_star = rng.normal(size=REG_D).astype("f4") / np.sqrt(REG_D)
    X = rng.normal(size=(m, n, REG_D)).astype("f4")
    y = X @ w_star + 0.5 * rng.normal(size=(m, n)).astype("f4")
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in (w_star, X, y))


def regression_error(bcfg: ByzantineConfig, m: int, n: int, steps: int,
                     seed: int = 0, device="cuda", schedule=None) -> float:
    """``steps`` steps of robust gradient descent (lr REG_LR) from w = 0
    on m workers' least-squares losses, each worker holding n samples;
    returns the final ‖w − w*‖ (inf when it diverged).

    Without ``schedule`` every step is the fixed-m round: apply_dense
    and the registered aggregator.  With an ArrivalSchedule each step is
    an elastic round over ``schedule.active(t)``: membership, knowledge
    and aggregation over the active workers only."""
    dev = resolve_device(device)
    w_star, X, y = regression_problem(m, n, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def grads(w):
        return torch.einsum("mnd,mn->md", X, torch.matmul(X, w) - y) / n

    def fixed_step(w):
        G = threat.apply_dense(grads(w), gen, bcfg)
        return w - REG_LR * aggregators.aggregate(G, bcfg)

    def elastic_step(w, act):
        G = threat.apply_dense(grads(w), gen, bcfg, active=act)
        return w - REG_LR * engine.aggregate_local(G, bcfg, valid=act)

    w = torch.zeros(REG_D, dtype=torch.float32, device=dev)
    for t in range(steps):
        if schedule is None:
            w = fixed_step(w)
        else:
            w = elastic_step(w, torch.as_tensor(schedule.active(t),
                                                device=dev))
    e = float(torch.linalg.vector_norm(w - w_star))
    return e if math.isfinite(e) else float("inf")
