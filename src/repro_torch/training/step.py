"""The BrSGD train step: m simulated workers on one device.

Port of the JAX package's ``training/step.py``, global scope.  The
reference runs one worker per mesh device: a ``vmap`` of
``value_and_grad`` over the worker axis, the attack and the robust
aggregation inside a shard_map, the optimizer update outside.  Here one
device holds every worker, as the port's paper loop does
(``core/simulate.py``):

1. each worker's ``loss_fn`` and its gradient over every parameter
   (``torch.autograd.grad``; B6 / B6-bwd or B7 / B7-bwd on the card),
   each gradient written into its own row of G [m, D], allocated once
   per ``build_train_step`` call.  A row lays the leaves out in the
   parameter tree's order (``models.params.tree_leaves``: keys sorted at
   every level, the ``jax.tree`` order), so G is the reference's
   flattened gradient stack.  In an elastic round an inactive worker's loss is taken
   without its gradient and its row is zero (the round zeroes it
   anyway);
2. the gradient attack on G in place (``threat.apply_dense_``) under
   the step's generator;
3. the aggregation: ``engine.aggregate_local`` (brsgd's fixed round is
   one launch on the card), or in an elastic round its masked round over
   column blocks, zeroing the inactive rows of G in place;
4. the aggregate, split into views of the parameters' shapes, goes to
   ``opt.update``, which updates params and state in place.

Metrics as the reference's: ``loss`` and ``ce`` (means over the
workers; with the guard over the active, finite ones), ``gnorm`` (the
aggregate's norm before clipping), ``n_selected`` and
``n_selected_min`` (equal in the global scope), ``n_active``; the guard
adds ``worker_ok`` ([m] numpy), ``step_ok``, ``grad_finite`` and
``loss_spike``.  Scalars come back as Python floats.

The guard's hold is decided on the host before the update: a held step
never touches params or optimizer state, so they are the input's bits.

The blocked scope (per-bucket aggregation inside the backward, ROADMAP
A.4) and the a2a layout wait for the port's distributed layouts.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import TrainConfig
from ..core import engine, threat
from ..models import params as PM
from ..models import transformer as TF
from ..optim import get_optimizer, global_norm

GIANT_PARAMS = 20e9


def resolve_strategy(tcfg: TrainConfig) -> tuple:
    """(scope, layout) with ``agg_scope="auto"`` resolved by model size:
    blocked above 20e9 parameters, else global.  ``agg_layout="auto"``
    stays "auto" in the global scope (one device holds all of G, so the
    local executor runs it) and becomes "a2a" in the blocked one."""
    n = PM.count_params(TF.param_defs(tcfg.model))
    scope = tcfg.agg_scope
    if scope == "auto":
        scope = "blocked" if n > GIANT_PARAMS else "global"
    layout = tcfg.agg_layout
    if layout == "auto" and scope == "blocked":
        layout = "a2a"
    return scope, layout


class StepBundle(NamedTuple):
    step_fn: Callable     # (params, opt_state, batch, step, key, ...) -> ...
    opt_init: Callable    # params tree -> optimizer state (lists of leaves)
    scope: str
    layout: str
    m: int


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's generator (the reference's ``fold_in(key, step)``): a
    ``torch.Generator`` on ``device`` seeded from (seed, step)."""
    s = np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def _unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def _host_mask(v, m: int, fill: float) -> np.ndarray:
    if v is None:
        return np.full(m, fill, np.float32)
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32).reshape(m)


def _build_global_step(tcfg: TrainConfig, m: int, device):
    """The global-scope round: (params, batch, step, key, active,
    faults) -> (param leaves, aggregate leaves, metrics), every worker's
    gradient in one G on ``device``; the update is the caller's."""
    cfg, bcfg = tcfg.model, tcfg.byzantine
    remat = tcfg.remat == "block"
    elastic, guard = bcfg.elastic, tcfg.recovery.guard
    shapes = [tuple(d.shape) for d in PM.tree_leaves(TF.param_defs(cfg))]
    sizes = [math.prod(s) for s in shapes]
    offs = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    D = offs[-1]
    cache = {}

    def G_buffer():
        if "G" not in cache:
            cache["G"] = torch.empty((m, D), dtype=torch.float32,
                                     device=device)
        return cache["G"]

    def round_(params, batch, step_idx, key, act, flt):
        leaves = PM.tree_leaves(params)
        if [tuple(p.shape) for p in leaves] != shapes:
            raise ValueError(f"params do not have {cfg.name}'s leaves")
        G = G_buffer()
        wbatch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if wbatch["tokens"].shape[0] != m:
            raise ValueError(f"batch has {wbatch['tokens'].shape[0]} "
                             f"workers, the step {m}")
        rg = [p.detach().requires_grad_(True) for p in leaves]
        ptree = _unflatten(params, rg)
        nan = torch.tensor(float("nan"), device=device)
        losses, ces = [], []
        for i in range(m):
            wb = {k: v[i] for k, v in wbatch.items()}
            # the guard's fault rides the loss inside the differentiated
            # function: the whole gradient of the worker turns NaN, as a
            # blow-up on its device would
            faulted = guard and flt[i] > 0
            if elastic and act[i] <= 0:
                with torch.no_grad():
                    loss, met = TF.loss_fn(cfg, params, wb)
                    if faulted:
                        loss = loss * nan
                G[i].zero_()
            else:
                with torch.enable_grad():
                    loss, met = TF.loss_fn(cfg, ptree, wb, remat=remat)
                    if faulted:
                        loss = loss * nan
                    grads = torch.autograd.grad(loss, rg)
                row = G[i]
                for g, a, b in zip(grads, offs[:-1], offs[1:]):
                    row[a:b].copy_(g.reshape(-1))
                del grads
            losses.append(loss.detach())
            ces.append(met["ce"].detach())
        del rg, ptree
        gen = (key if isinstance(key, torch.Generator)
               else step_generator(tcfg.seed, step_idx, device))
        vf = (torch.from_numpy(act).to(device) if elastic else None)
        threat.apply_dense_(G, gen, bcfg, active=vf)
        if elastic:
            agg, st = engine.aggregate_local(G, bcfg, return_state=True,
                                             valid=vf, inplace=True)
        else:
            agg, st = engine.aggregate_local(G, bcfg, return_state=True)
        if st is not None:
            n_sel = float(st.selected.sum())
        else:
            n_sel = float((act > 0).sum()) if elastic else float(m)
        agg_leaves = [agg[a:b].view(s)
                      for a, b, s in zip(offs[:-1], offs[1:], shapes)]
        loss_v, ce_v = torch.stack(losses), torch.stack(ces)
        metrics = {"gnorm": float(global_norm(agg_leaves))}
        if guard:
            ok_i = torch.isfinite(loss_v)
            w = torch.from_numpy((act > 0).astype(np.float32)).to(device) \
                * ok_i.to(torch.float32)
            denom = torch.clamp(w.sum(), min=1.0)
            metrics["loss"] = float(torch.sum(
                w * torch.where(ok_i, loss_v, 0.0)) / denom)
            metrics["ce"] = float(torch.sum(
                w * torch.where(torch.isfinite(ce_v), ce_v, 0.0)) / denom)
            metrics["worker_ok"] = ok_i.to(torch.float32).cpu().numpy()
        else:
            metrics["loss"] = float(loss_v.mean())
            metrics["ce"] = float(ce_v.mean())
        metrics["n_selected"] = metrics["n_selected_min"] = n_sel
        return leaves, agg_leaves, metrics

    return round_


def build_train_step(tcfg: TrainConfig, m: int,
                     device="cuda") -> StepBundle:
    """The train step of ``tcfg`` for ``m`` simulated workers on
    ``device`` (the card unless the caller asks for the CPU).

    ``step_fn(params, opt_state, batch, step, key)`` takes the parameter
    tree, the optimizer state (``opt_init(params)``), ``{"tokens": [m,
    B, S]}`` (numpy or tensor), the step index and the step's generator
    (``step_generator``; None seeds one from (``tcfg.seed``, step)), and
    returns (params, opt_state, metrics) with params and state updated in
    place.

    When ``tcfg.byzantine`` is elastic (quorum/max_m set) the step takes
    a sixth argument ``active`` ([m] 0/1, who reached this round's
    quorum), all-ones by default; passing ``active`` to a fixed step is
    an error.  With ``tcfg.recovery.guard`` (requires elastic) it also
    takes ``faults`` ([m] 0/1 grad-fault flags) and ``loss_ema`` (< 0 or
    None disarms the spike detector) and returns ``worker_ok``,
    ``step_ok``, ``grad_finite`` and ``loss_spike``; a non-finite or
    spiking step leaves params and optimizer state as they were."""
    scope, layout = resolve_strategy(tcfg)
    if scope != "global":
        raise ValueError(
            f"agg_scope={scope!r} is not ported yet: the blocked scope "
            f"waits for ROADMAP A.4 (the distributed layouts); use "
            f"agg_scope='global'")
    if layout not in ("gather", "auto"):
        raise ValueError(
            f"agg_layout={layout!r} is not ported yet: it waits for ROADMAP "
            f"A.4 (the distributed layouts); one device holds all of G, so "
            f"'gather' and 'auto' run the local executor")
    bcfg, rcfg = tcfg.byzantine, tcfg.recovery
    if rcfg.guard and not bcfg.elastic:
        raise ValueError(
            "recovery.guard requires an elastic ByzantineConfig (set "
            "quorum/max_m): eviction and hold are expressed through the "
            "active mask")
    if bcfg.elastic:
        if bcfg.max_m and bcfg.max_m != m:
            raise ValueError(
                f"ByzantineConfig.max_m={bcfg.max_m} does not match the "
                f"step's {m} worker slots for scope={scope!r}")
        if bcfg.quorum > m:
            raise ValueError(
                f"ByzantineConfig.quorum={bcfg.quorum} exceeds the step's "
                f"{m} worker slots for scope={scope!r}")
    dev = resolve_device(device)
    opt = get_optimizer(tcfg)
    round_ = _build_global_step(tcfg, m, dev)

    def opt_init(params):
        return opt.init(PM.tree_leaves(params))

    def run(params, opt_state, batch, step_idx, key, act, flt, hold):
        leaves, agg, met = round_(params, batch, step_idx, key, act, flt)
        if not hold(met):
            opt.update(agg, opt_state, leaves, step_idx)
        return params, opt_state, met

    if rcfg.guard:
        def step(params, opt_state, batch, step_idx, key, active=None,
                 faults=None, loss_ema=None):
            act = _host_mask(active, m, 1.0)
            flt = _host_mask(faults, m, 0.0)
            ema = np.float32(-1.0 if loss_ema is None else loss_ema)
            flags = {}

            def hold(met):
                loss = np.float32(met["loss"])
                grad_ok = bool(np.isfinite(met["gnorm"]))
                loss_ok = bool(np.isfinite(loss))
                spike = bool(ema > 0 and loss > np.float32(rcfg.spike_mult)
                             * ema)
                flags.update(ok=grad_ok and loss_ok and not spike,
                             grad_ok=grad_ok, spike=spike)
                return not flags["ok"]

            params, opt_state, met = run(params, opt_state, batch, step_idx,
                                         key, act, flt, hold)
            met.update(n_active=float(act.sum()),
                       step_ok=float(flags["ok"]),
                       grad_finite=float(flags["grad_ok"]),
                       loss_spike=float(flags["spike"]))
            return params, opt_state, met
    elif bcfg.elastic:
        def step(params, opt_state, batch, step_idx, key, active=None):
            act = _host_mask(active, m, 1.0)
            params, opt_state, met = run(params, opt_state, batch, step_idx,
                                         key, act, None, lambda met: False)
            return params, opt_state, {**met, "n_active": float(act.sum())}
    else:
        def step(params, opt_state, batch, step_idx, key, active=None):
            if active is not None:
                raise ValueError(
                    "active mask passed to a non-elastic step; set "
                    "ByzantineConfig.quorum (or max_m) to opt in")
            act = np.ones(m, np.float32)
            params, opt_state, met = run(params, opt_state, batch, step_idx,
                                         key, act, None, lambda met: False)
            return params, opt_state, {**met, "n_active": float(m)}

    return StepBundle(step, opt_init, scope, layout, m)
