"""Single-process m-worker Byzantine SGD simulation — the paper's own
loop (m=20, LeNet/FashionMNIST): per-worker gradients with
``torch.func.vmap(grad)`` over a leading worker axis, a gradient-space
attack on G [m, d], any registered aggregator, plain SGD."""
from __future__ import annotations

from typing import Callable

import torch

from .. import resolve_device
from ..configs.base import ByzantineConfig
from . import engine, threat


def tree_to_vec(tree: dict):
    """Flatten a parameter dict in sorted key order (the JAX package's
    ``jax.tree.leaves`` order), each leaf in its own row-major layout."""
    return torch.cat([tree[k].reshape(-1).to(torch.float32)
                      for k in sorted(tree)])


def vec_to_tree(vec, like: dict) -> dict:
    out, o = {}, 0
    for k in sorted(like):
        n = like[k].numel()
        out[k] = vec[o:o + n].reshape(like[k].shape).to(like[k].dtype)
        o += n
    return out


def worker_grad_matrix(loss_fn: Callable, params: dict, worker_batches: dict):
    """G [m, d]: per-worker flattened gradients.  ``worker_batches`` is a
    dict of tensors with the leading worker axis m."""
    grads = torch.func.vmap(torch.func.grad(loss_fn),
                            in_dims=(None, 0))(params, worker_batches)
    m = next(iter(worker_batches.values())).shape[0]
    return torch.cat([grads[k].reshape(m, -1).to(torch.float32)
                      for k in sorted(grads)], dim=1)


def make_sim_step(loss_fn: Callable, bcfg: ByzantineConfig, lr: float,
                  device="cuda"):
    """Plain-SGD simulation step on ``device`` (the card unless the
    caller passes ``device="cpu"``).

    ``step(params, worker_batches, generator)`` returns ``(new_params,
    {"gnorm", "n_selected", "selected"})``; ``generator`` (a
    ``torch.Generator`` on the device) drives key-driven attacks.  The
    selection ([m] bool) and its count come from the aggregator's
    SelectionState (column rules select all m)."""
    dev = resolve_device(device)

    def step(params, worker_batches, generator):
        batches = {k: torch.as_tensor(v, device=dev)
                   for k, v in worker_batches.items()}
        G = worker_grad_matrix(loss_fn, params, batches)
        G = threat.apply_dense(G, generator, bcfg)
        agg, st = engine.aggregate_local(G, bcfg, return_state=True)
        upd = vec_to_tree(agg, params)
        new_params = {k: params[k] - lr * upd[k] for k in params}
        selected = (st.selected if st is not None else
                    torch.ones(G.shape[0], dtype=torch.bool, device=dev))
        return new_params, {"gnorm": torch.linalg.vector_norm(agg),
                            "n_selected": selected.to(torch.float32).sum(),
                            "selected": selected}

    return step
