"""Minimal optimizer library, on lists of float32 tensors.

Port of the JAX package's ``optim/optimizers.py``.  Parameters, the
aggregate and every state are lists of tensors in the parameter tree's
leaf order (``models.params.tree_leaves``): sgd keeps ``()``, momentum
one list, adamw ``{"m": [...], "v": [...]}``.  Accumulators are
float32.

``update(grads, state, params, step)`` writes the new params and state
into the given tensors in place and returns them: at qwen3-0.6b's full
width a second copy of params and adamw state would be 7 GB more on the
card.  It consumes ``grads`` (clipping scales them in place).  The
arithmetic follows the reference's out-of-place formulas operation by
operation (``b1·m + (1-b1)·g``, ``(m/c1) / (sqrt(v/c2) + eps)``, ...),
so the results are the reference's values.  Like the reference, which
computes the update in plain jnp, this is plain torch: no kernel of the
port replaces it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..configs.base import TrainConfig


class Optimizer(NamedTuple):
    init: Callable      # params -> state
    update: Callable    # (grads, state, params, step) -> (params, state)


def global_norm(tensors):
    """sqrt(Σ over the tensors of Σ x²) in float32, summed tensor by
    tensor in list order as the reference's ``_global_norm``."""
    total = None
    for x in tensors:
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale the tensors of ``grads`` in place by min(1, max_norm /
    max(norm, 1e-9)) and return them; a no-op at ``max_norm <= 0``."""
    if max_norm <= 0:
        return grads
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.device))
    return grads


def _step_f32(step, device):
    return torch.as_tensor(step, device=device).to(torch.float32)


def sgd(lr: float, grad_clip: float = 0.0) -> Optimizer:
    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params, step):
        grads = clip_by_global_norm(grads, grad_clip)
        for p, g in zip(params, grads):
            p.sub_(g.mul_(lr))
        return params, state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9, grad_clip: float = 0.0) -> Optimizer:
    def init(params):
        return [torch.zeros_like(p, dtype=torch.float32) for p in params]

    @torch.no_grad()
    def update(grads, state, params, step):
        grads = clip_by_global_norm(grads, grad_clip)
        for p, g, v in zip(params, grads, state):
            v.mul_(beta).add_(g)
            p.sub_(g.copy_(v).mul_(lr))
        return params, state

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, grad_clip: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
                "v": [torch.zeros_like(p, dtype=torch.float32) for p in params]}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads = clip_by_global_norm(grads, grad_clip)
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            t = _step_f32(step, p.device) + 1.0
            c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                              device=p.device), t)
            c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                              device=p.device), t)
            m.mul_(b1).add_(g * (1 - b1))               # b1·m + (1-b1)·g
            g2 = g * (1 - b2)
            v.mul_(b2).add_(g2.mul_(g))                 # b2·v + (1-b2)·g·g
            den = torch.div(v, c2).sqrt_().add_(eps)    # sqrt(v/c2) + eps
            u = g.copy_(m).div_(c1).div_(den)           # (m/c1) / den
            del den, g2
            u.add_(p * weight_decay)                    # u + wd·p
            p.sub_(u.mul_(lr))                          # p - lr·(...)
        return params, state

    return Optimizer(init, update)


def get_optimizer(cfg: TrainConfig) -> Optimizer:
    if cfg.optimizer == "sgd":
        return sgd(cfg.lr, cfg.grad_clip)
    if cfg.optimizer == "momentum":
        return momentum(cfg.lr, cfg.momentum, cfg.grad_clip)
    if cfg.optimizer == "adamw":
        return adamw(cfg.lr, weight_decay=cfg.weight_decay,
                     grad_clip=cfg.grad_clip)
    raise ValueError(cfg.optimizer)
