"""The BrSGD train step: m simulated workers on one device.

Port of the JAX package's ``training/step.py``, both scopes.  The
reference runs one worker per mesh device: a ``vmap`` of
``value_and_grad`` over the worker axis, the attack and the robust
aggregation inside a shard_map, the optimizer update outside.  Here one
device holds every worker, as the port's paper loop does
(``core/simulate.py``).  The global scope:

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

The blocked scope (``agg_scope="blocked"``, or "auto" above 20e9
parameters; :func:`_build_blocked_step`) aggregates each bucket (a layer
slice, a hybrid unit, or the top-level rest) inside one layer-major
backward of every worker (``core.blocked``), so no [m, D] buffer
exists; its selections are per bucket, ``n_selected`` is the mean over
the bucket calls and ``n_selected_min`` their smallest count.  The
update then runs on the aggregated leaves exactly as in the global
scope (clipped by the aggregate's global norm).

The guard's hold is decided on the host before the update: a held step
never touches params or optimizer state, so they are the input's bits.

With ``mesh=`` (``launch.mesh``) the global scope runs as the reference
does, one rank a worker (:func:`_build_mesh_step`): each rank takes its
worker's gradient on its row of the [m, B, S] batch, keeps its model
shard (``models.params.pspec_tree``), and ``threat.inject`` and
``distributed.robust_aggregate`` run across the ranks in the "gather" or
"a2a" layout, or an explicit per-leaf plan; the aggregate's model shards
are all-gathered and every rank takes the same update.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import TrainConfig
from ..core import blocked, collectives, engine, threat
from ..core.distributed import robust_aggregate
from ..models import params as PM
from ..models import transformer as TF
from ..optim import get_optimizer, global_norm

GIANT_PARAMS = 20e9


def resolve_strategy(tcfg: TrainConfig) -> tuple:
    """(scope, layout) with ``agg_scope="auto"`` resolved by model size:
    blocked above 20e9 parameters, else global.  ``agg_layout="auto"``
    stays "auto" in the global scope (one device holds all of G, so the
    local executor runs it) and becomes "a2a" in the blocked one, as in
    the reference; on one device every blocked layout runs the same
    code."""
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
        ptree = PM.tree_unflatten(params, rg)
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
        metrics = {"gnorm": float(global_norm(agg_leaves))}
        _loss_metrics(metrics, losses, ces, act, guard, device)
        metrics["n_selected"] = metrics["n_selected_min"] = n_sel
        return leaves, agg_leaves, metrics

    return round_


def _loss_metrics(metrics, losses, ces, act, guard: bool, device):
    """``loss`` and ``ce`` into ``metrics``: means over the workers, or
    with the guard over the active, finite ones (exact where-masking, so
    one NaN worker cannot keep the run's loss NaN), and ``worker_ok``."""
    loss_v, ce_v = torch.stack(losses), torch.stack(ces)
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
    return metrics


def _build_mesh_step(tcfg: TrainConfig, mesh, device, layout: str,
                     plan=None):
    """The global-scope round with one rank a worker: (params, batch,
    step, key, active, faults) -> (param leaves, aggregate leaves,
    metrics); the update is the caller's, alike on every rank.

    The rank takes its worker's loss and gradient over every parameter
    on its row of the batch (an inactive worker's loss only; its
    gradient is zero), keeps the model shard of each leaf that
    ``pspec_tree`` shards (the reference's GSPMD loss computes the same
    numbers; tensor-parallel compute is not ported), runs
    ``threat.inject`` and ``robust_aggregate`` over the worker axes,
    then all-gathers the aggregate's model shards.  The workers' losses
    are all-gathered for the metrics."""
    from ..launch.mesh import n_workers, worker_axes
    cfg, bcfg = tcfg.model, tcfg.byzantine
    remat = tcfg.remat == "block"
    elastic, guard = bcfg.elastic, tcfg.recovery.guard
    waxes = worker_axes(mesh)
    maxes = tuple(a for a in mesh.axis_names if a not in waxes)
    m, me = n_workers(mesh), mesh.index(waxes)
    defs = TF.param_defs(cfg)
    shapes = [tuple(d.shape) for d in PM.tree_leaves(defs)]
    specs = PM.tree_leaves(PM.pspec_tree(defs, mesh))
    views = [PM.shard_view(s, ps, mesh) for s, ps in zip(shapes, specs)]

    def round_(params, batch, step_idx, key, act, flt):
        leaves = PM.tree_leaves(params)
        if [tuple(p.shape) for p in leaves] != shapes:
            raise ValueError(f"params do not have {cfg.name}'s leaves")
        if np.shape(batch["tokens"])[0] != m:
            raise ValueError(f"batch has {np.shape(batch['tokens'])[0]} "
                             f"workers, the mesh {m}")
        wb = {k: torch.as_tensor(v[me]).to(device) for k, v in batch.items()}
        nan = torch.tensor(float("nan"), device=device)
        faulted = guard and flt[me] > 0
        if elastic and act[me] <= 0:
            with torch.no_grad():
                loss, met = TF.loss_fn(cfg, params, wb)
                if faulted:
                    loss = loss * nan
            grads = [torch.zeros_like(p) for p in leaves]
        else:
            rg = [p.detach().requires_grad_(True) for p in leaves]
            with torch.enable_grad():
                loss, met = TF.loss_fn(cfg, PM.tree_unflatten(params, rg), wb,
                                       remat=remat)
                if faulted:
                    loss = loss * nan
                grads = list(torch.autograd.grad(loss, rg))
            del rg
        local = [g[v].contiguous() for g, v in zip(grads, views)]
        del grads
        gen = (key if isinstance(key, torch.Generator)
               else step_generator(tcfg.seed, step_idx, device))
        vf = torch.from_numpy(act).to(device) if elastic else None
        local = threat.inject(local, gen, bcfg, mesh, waxes,
                              leaf_specs=specs, model_axes=maxes,
                              active=vf)
        agg, st = robust_aggregate(local, bcfg, mesh, waxes, layout=layout,
                                   model_axes=maxes, leaf_specs=specs,
                                   valid=vf, plan=plan)
        del local
        if st is not None:
            n_sel = float(st.selected.sum())
        else:
            n_sel = float((act > 0).sum()) if elastic else float(m)
        agg_leaves = []
        for a, s, v in zip(agg, shapes, views):
            if v == (slice(None),) * len(s):
                agg_leaves.append(a)
                continue
            # the model shards, gathered in model-axis order along the
            # sharded dimension
            dim = next(i for i, sl in enumerate(v) if sl != slice(None))
            parts = collectives.all_gather(a, mesh, maxes)
            agg_leaves.append(torch.cat(list(parts), dim=dim))
        del agg
        lc = collectives.all_gather(
            torch.stack([loss.detach().to(torch.float32),
                         met["ce"].detach().to(torch.float32)]), mesh, waxes)
        metrics = {"gnorm": float(global_norm(agg_leaves))}
        _loss_metrics(metrics, list(lc[:, 0]), list(lc[:, 1]), act, guard,
                      device)
        metrics["n_selected"] = metrics["n_selected_min"] = n_sel
        return leaves, agg_leaves, metrics

    return round_


def _build_blocked_step(tcfg: TrainConfig, m: int, device):
    """The blocked-scope round: (params, batch, step, key, active,
    faults) -> (param leaves, aggregate leaves, metrics), each bucket
    aggregated inside the backward (``core.blocked``); the update is the
    caller's.

    The active workers run layer-major through
    ``transformer.loss_fn_workers`` with one barrier a layer slice (unit
    slice for hybrid) and one for the top-level bucket, and one backward
    (``torch.autograd.grad`` of their losses with respect to the buckets'
    selection tokens: the parameters take no gradient).  Each bucket's
    gate writes its aggregate into the aggregate leaves, allocated once
    per ``build_train_step`` call; no [m, D] buffer exists.  An inactive
    worker's loss is taken without its gradient: its rows stay zero, as
    the reference's ``where`` leaves them.  The byzantine membership is
    drawn once a step from the step's generator, so every bucket
    corrupts the same workers; noise is drawn per (bucket, layer)."""
    cfg, bcfg = tcfg.model, tcfg.byzantine
    remat = tcfg.remat == "block"
    elastic, guard = bcfg.elastic, tcfg.recovery.guard
    shapes = [tuple(d.shape) for d in PM.tree_leaves(TF.param_defs(cfg))]
    segs = TF.segments(cfg)
    cache = {}

    def agg_buffers():
        if "agg" not in cache:
            cache["agg"] = [torch.empty(s, dtype=torch.float32,
                                        device=device) for s in shapes]
        return cache["agg"]

    def round_(params, batch, step_idx, key, act, flt):
        leaves = PM.tree_leaves(params)
        if [tuple(p.shape) for p in leaves] != shapes:
            raise ValueError(f"params do not have {cfg.name}'s leaves")
        wbatch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if wbatch["tokens"].shape[0] != m:
            raise ValueError(f"batch has {wbatch['tokens'].shape[0]} "
                             f"workers, the step {m}")
        workers = [i for i in range(m) if not elastic or act[i] > 0]
        if not workers:
            raise ValueError("no active worker in the round")
        gen = (key if isinstance(key, torch.Generator)
               else step_generator(tcfg.seed, step_idx, device))
        vf = torch.from_numpy(act).to(device) if elastic else None
        rnd = blocked.BlockedRound(
            bcfg, m, workers, gen.initial_seed(),
            threat.step_membership(bcfg, m, gen, active=vf, device=device),
            vf)
        agg_leaves = agg_buffers()
        agg_tree = PM.tree_unflatten(params, agg_leaves)
        toks = {k: blocked.selection_token(m, device)
                for k in [f"seg_{i}" for i in range(len(segs))] + ["top"]}
        barriers = {k: blocked.make_agg_barrier(rnd, k) for k in toks}
        outs = {f"seg_{i}": TF._layers(agg_tree[f"seg_{i}"], seg.n)
                for i, seg in enumerate(segs)}

        def seg_hook(k):
            return lambda p_l, idx: barriers[k](
                p_l, toks[k], idx, PM.tree_leaves(outs[k][idx])).workers()
        top_views = barriers["top"](TF._top(params), toks["top"], 0,
                                    PM.tree_leaves(TF._top(agg_tree)))
        nan = torch.tensor(float("nan"), device=device)
        losses, ces = [None] * m, [None] * m
        with torch.enable_grad():
            run, mets = TF.loss_fn_workers(
                cfg, params, [{k: v[i] for k, v in wbatch.items()}
                              for i in workers],
                remat=remat, seg_hooks={k: seg_hook(k) for k in outs},
                top_hook=lambda sub: top_views.workers(sub))
            for j, i in enumerate(workers):
                # the guard's fault rides the loss: the worker's whole
                # gradient turns NaN, as a blow-up on its device would
                if guard and flt[i] > 0:
                    run[j] = run[j] * nan
            grads = torch.autograd.grad(run, list(toks.values()),
                                        allow_unused=True)
        for j, i in enumerate(workers):
            losses[i], ces[i] = run[j].detach(), mets[j]["ce"].detach()
        del run, mets, top_views
        for i in range(m):
            if losses[i] is None:
                with torch.no_grad():
                    loss, met = TF.loss_fn(cfg, params,
                                           {k: v[i] for k, v in
                                            wbatch.items()})
                    if guard and flt[i] > 0:
                        loss = loss * nan
                losses[i], ces[i] = loss, met["ce"]
        want = sum(seg.n for seg in segs) + 1
        if len(rnd.calls) != want:
            raise RuntimeError(f"{len(rnd.calls)} bucket aggregations in "
                               f"the backward, expected {want}")
        # each token's gradient is one_hot(n_selected) per gate call;
        # summed, a histogram over the counts 0..m
        hist = sum(g for g in grads if g is not None).cpu().numpy()
        counts = np.arange(m + 1, dtype=np.float32)
        n_sel = np.float32(np.sum(counts * hist, dtype=np.float32)) \
            / np.float32(max(np.sum(hist, dtype=np.float32), 1.0))
        metrics = {"gnorm": float(global_norm(agg_leaves)),
                   "n_selected": float(n_sel),
                   "n_selected_min": float(np.argmax(hist > 0))}
        _loss_metrics(metrics, losses, ces, act, guard, device)
        return leaves, agg_leaves, metrics

    return round_


def build_train_step(tcfg: TrainConfig, m: int | None = None,
                     device="cuda", mesh=None, plan=None) -> StepBundle:
    """The train step of ``tcfg`` for ``m`` simulated workers on
    ``device`` (the card unless the caller asks for the CPU), or, with
    ``mesh`` (this rank's ``launch.mesh.Mesh``), with one rank a worker
    and m and the device the mesh's (:func:`_build_mesh_step`).

    ``tcfg.agg_scope`` picks the scope (:func:`resolve_strategy`).  The
    blocked scope takes every layout the reference's does ("gather",
    "a2a", "auto"): with every worker on one device they all run the
    same code, the bucket aggregate on the bucket's rows; across ranks
    it waits for ROADMAP A.4.  On one device the global scope runs the
    local executor for "gather" and "auto" and refuses "a2a", which
    needs ranks; on a mesh it takes "gather", "a2a", or "auto" with an
    explicit per-leaf ``plan`` (without one, "auto" waits for the cost
    model, ROADMAP A.6).

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
    if scope not in ("global", "blocked"):
        raise ValueError(f"unknown agg_scope {scope!r}")
    if layout not in ("gather", "a2a", "auto"):
        raise ValueError(f"unknown agg_layout {layout!r}")
    if mesh is not None:
        from ..launch.mesh import n_workers
        if scope != "global":
            raise ValueError(
                f"agg_scope={scope!r} across ranks waits for the blocked "
                f"scope's FSDP gathers (ROADMAP A.4); mesh= runs the global "
                f"scope")
        if m is not None and m != n_workers(mesh):
            raise ValueError(f"m={m} but the mesh has {n_workers(mesh)} "
                             f"workers")
        m = n_workers(mesh)
        if layout == "auto" and plan is None:
            raise ValueError(
                "agg_layout='auto' across ranks needs an explicit plan: the "
                "cost model that resolves it (analysis/costmodel) waits for "
                "ROADMAP A.6")
    elif m is None:
        raise ValueError("build_train_step needs m, or mesh=")
    elif scope == "global" and layout == "a2a":
        raise ValueError(
            "agg_layout='a2a' in the global scope needs ranks: pass mesh= "
            "(launch.mesh; ROADMAP A.4's torch.distributed layouts); one "
            "device holds all of G, so 'gather' and 'auto' run the local "
            "executor")
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
    dev = mesh.device if mesh is not None else resolve_device(device)
    opt = get_optimizer(tcfg)
    if mesh is not None:
        round_ = _build_mesh_step(tcfg, mesh, dev, layout, plan)
    else:
        build = (_build_blocked_step if scope == "blocked"
                 else _build_global_step)
        round_ = build(tcfg, m, dev)

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
