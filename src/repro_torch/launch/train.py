"""Training entry point of the port (the twin of the JAX package's
``python -m repro.launch.train``): BrSGD with m simulated workers on one
device (``--workers``: one card holds every worker, as the port's paper
loop does), or with one rank a worker (``--mesh``: ``4`` for 4 workers,
``2x2`` for 2 workers each split over 2 model ranks, as the JAX
launcher takes it; the ranks are spawned processes in a gloo group,
every one on ``cuda:0`` on one card, each CPU rank on its share of the
host's cores).

    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 20 \
        --attack sign_flip --alpha 0.25                  # on the card
    python -m repro_torch.launch.train --reduced --device cpu --workers 8
    python -m repro_torch.launch.train --reduced --device cpu --mesh 4 \
        --agg-layout a2a --optimizer sgd

``--quorum`` / ``--straggle`` run elastic rounds (an ``ArrivalSchedule``
picks each step's active workers), ``--supervise`` the guarded step under
the recovery supervisor, ``--ckpt-dir`` / ``--ckpt-every`` save the
port's checkpoints (the JAX package's format) with a telemetry row per
logged step beside them (``--mesh``: rank 0 writes them).  Params are
float32, drawn from the config's seed (the same on every rank).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import time


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-per-worker", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--workers", type=int, default=None,
                    help="simulated workers m on the one device (default "
                         "the paper's m = 20; not with --mesh)")
    ap.add_argument("--mesh", default=None,
                    help="one rank a worker: N (N workers) or NxM (N "
                         "workers, each over M model ranks); needs "
                         "--agg-layout gather or a2a")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the CPU runs only when "
                         "asked for")
    ap.add_argument("--aggregator", default="brsgd",
                    help="any rule registered in core.engine")
    ap.add_argument("--attack", default="none",
                    help="'none' or any attack registered in core.threat")
    ap.add_argument("--alpha", type=float, default=0.0)
    ap.add_argument("--membership", default="prefix",
                    choices=["prefix", "random", "resample"],
                    help="byzantine-membership policy (core.threat)")
    ap.add_argument("--quorum", type=int, default=0,
                    help="fire aggregation once this many workers have "
                         "arrived (0 = synchronous full round); opts the "
                         "step into the elastic path")
    ap.add_argument("--straggle", default="none",
                    help="arrival-delay distribution dist[:scale], dist in "
                         "none|exp|pareto — e.g. 'exp:0.5' (data.pipeline."
                         "ArrivalSchedule)")
    ap.add_argument("--supervise", action="store_true",
                    help="run under the recovery supervisor: in-step "
                         "finite/spike guard, worker eviction, bounded "
                         "rollback to last_good.  Implies the elastic path "
                         "(quorum defaults to the full worker count)")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--agg-layout", default="auto")
    ap.add_argument("--agg-scope", default="auto")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save an (atomic) checkpoint every N steps into "
                         "--ckpt-dir; 0 = final step only.  A serving "
                         "HotSwapper polling the same directory hot-swaps "
                         "each one live")
    ap.add_argument("--log-every", type=int, default=1)
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)

    from ..core import engine, threat
    from ..data.pipeline import parse_straggle
    from .mesh import launch, parse_mesh

    if args.aggregator not in engine.registered():
        ap.error(f"--aggregator {args.aggregator!r}: "
                 f"choose from {', '.join(engine.registered())}")
    if args.attack != "none" and args.attack not in threat.registered():
        ap.error(f"--attack {args.attack!r}: choose from none, "
                 f"{', '.join(threat.registered())}")
    try:
        parse_straggle(args.straggle)
    except ValueError as e:
        ap.error(f"--straggle {args.straggle!r}: {e}")
    if args.mesh is None:
        return _run(args, None)
    if args.workers is not None:
        ap.error("--mesh and --workers exclude each other: the mesh's "
                 "worker axes give m")
    if args.agg_layout not in ("gather", "a2a"):
        ap.error(f"--mesh takes --agg-layout gather or a2a, not "
                 f"{args.agg_layout!r} ('auto' across ranks waits for the "
                 f"cost model, ROADMAP A.6)")
    if args.supervise:
        ap.error("--supervise with --mesh is not ported yet")
    try:
        shape, _axes = parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(f"--mesh {args.mesh!r}: {e}")
    world = math.prod(shape)
    # CPU ranks share the host's cores; card ranks keep torch's default
    threads = (max(1, (os.cpu_count() or 1) // world)
               if args.device == "cpu" else 0)
    return launch(_mesh_rank, world, (args,), backend="gloo",
                  device=args.device, threads=threads)[0]


def _mesh_rank(rank, args):
    from .mesh import make_mesh, parse_mesh
    shape, axes = parse_mesh(args.mesh)
    import torch
    dev = torch.device(args.device if args.device != "cuda"
                       else f"cuda:{torch.cuda.current_device()}")
    return _run(args, make_mesh(shape, axes, device=dev))


def _run(args, mesh):
    """The training loop on one device (``mesh`` None) or on this rank
    of ``mesh``; returns the logged history."""
    import dataclasses

    import torch

    from .. import resolve_device
    from ..checkpoint import ckpt
    from ..configs import (ByzantineConfig, RecoveryConfig, TrainConfig,
                           get_config)
    from ..core import threat
    from ..data.pipeline import (ArrivalSchedule, LMWorkerPipeline,
                                 parse_straggle)
    from ..faults import Supervisor
    from ..models import params as PM
    from ..models import transformer as TF
    from ..serving import telemetry
    from ..training.step import build_train_step, step_generator
    from .mesh import n_workers

    straggle, straggle_scale = parse_straggle(args.straggle)
    dev = resolve_device(args.device) if mesh is None else mesh.device
    m = n_workers(mesh) if mesh is not None else (args.workers or 20)
    lead = mesh is None or mesh.rank == 0
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    bcfg = ByzantineConfig(aggregator=args.aggregator, attack=args.attack,
                           alpha=args.alpha, membership=args.membership)
    tcfg = TrainConfig(model=cfg, byzantine=bcfg, optimizer=args.optimizer,
                       lr=args.lr, agg_layout=args.agg_layout,
                       agg_scope=args.agg_scope, remat=args.remat)

    # elastic rounds: any of --quorum, a straggle distribution, or a
    # timing-scope attack drops the synchronous-round assumption
    timing = (args.attack != "none"
              and threat.get_spec(args.attack).scope == "timing")
    elastic = (args.quorum > 0 or straggle != "none" or timing
               or args.supervise)
    sched = None
    if elastic:
        quorum = args.quorum or m
        bcfg = dataclasses.replace(bcfg, max_m=m, quorum=quorum)
        tcfg = dataclasses.replace(tcfg, byzantine=bcfg)
        sched = ArrivalSchedule(m, quorum, straggle, straggle_scale,
                                byz=bcfg, seed=tcfg.seed)
    if args.supervise:
        tcfg = dataclasses.replace(tcfg,
                                   recovery=RecoveryConfig(guard=True))

    bundle = (build_train_step(tcfg, m, dev) if mesh is None
              else build_train_step(tcfg, device=dev, mesh=mesh))
    defs = TF.param_defs(cfg)
    if lead:
        where = ("" if mesh is None else
                 f"mesh={dict(zip(mesh.axis_names, mesh.shape))} "
                 f"backend={mesh.backend} layout={bundle.layout} ")
        print(f"device={dev} {where}workers={m} scope={bundle.scope} "
              f"arch={cfg.name} params={PM.count_params(defs):,}",
              flush=True)
    params = PM.init_params(
        defs, torch.Generator(device=dev).manual_seed(tcfg.seed), device=dev)
    opt_state = bundle.opt_init(params)

    pipe = LMWorkerPipeline(cfg, m, args.batch_per_worker, args.seq,
                            seed=tcfg.seed, byz=bcfg)
    sup = None
    if args.supervise:
        sup = Supervisor(bundle.step_fn, bcfg, tcfg.recovery, m,
                         ckpt_dir=args.ckpt_dir, like=params)
    t_start = time.time()
    history = []
    for step in range(args.steps):
        batch = pipe.batch(step)
        gen = step_generator(tcfg.seed, step, dev)
        n_active = m
        if sup is not None:
            params, opt_state, met = sup.run_step(
                params, opt_state, batch, step, gen,
                sched_active=sched.active(step))
            n_active = int(met["n_active"])
        elif sched is not None:
            active = sched.active(step)
            n_active = int(active.sum())
            params, opt_state, met = bundle.step_fn(
                params, opt_state, batch, step, gen, active)
        else:
            params, opt_state, met = bundle.step_fn(
                params, opt_state, batch, step, gen)
        if step % args.log_every == 0 or step == args.steps - 1:
            met = {k: v if isinstance(v, str) else float(v)
                   for k, v in met.items() if k != "worker_ok"}
            history.append({"step": step, "n_active": n_active, **met})
            act_s = f" active={n_active}/{m}" if sched is not None else ""
            if lead:
                print(f"step {step:4d} loss={met['loss']:.4f} "
                      f"gnorm={met['gnorm']:.3f} "
                      f"selected={met['n_selected']:.1f}/{m} "
                      f"(bucket min {met['n_selected_min']:.0f})" + act_s,
                      flush=True)
            if args.ckpt_dir and lead:
                # robustness telemetry beside the checkpoints: the
                # server surfaces the aggregation stats the weights it
                # serves were trained under (serving/telemetry)
                telemetry.append_row(args.ckpt_dir, {
                    "step": step,
                    "gnorm": met["gnorm"],
                    "n_selected": met["n_selected"],
                    "n_selected_min": met["n_selected_min"],
                    "n_active": met["n_active"],
                    "quorum": bcfg.quorum or m,
                })
        if (args.ckpt_dir and lead and args.ckpt_every
                and (step + 1) % args.ckpt_every == 0):
            if sup is not None:
                sup.checkpoint(params, step + 1)
            else:
                ckpt.save(args.ckpt_dir, params, step=step + 1)

    dt = time.time() - t_start
    tok = args.steps * m * args.batch_per_worker * args.seq
    if not lead:
        return history
    print(f"done: {args.steps} steps, {dt:.1f}s, {tok/dt:.0f} tok/s")
    if sup is not None:
        s = sup.summary()
        print(f"supervisor: holds={s['holds']} evictions={s['evictions']} "
              f"rollbacks={s['rollbacks']} "
              f"quorum_shrinks={s['quorum_shrinks']} "
              f"quorum_holds={s['quorum_holds']}")
    if args.ckpt_dir:
        p = pathlib.Path(args.ckpt_dir)
        if sup is not None:
            sup.checkpoint(params, args.steps)
        else:
            ckpt.save(str(p), params, step=args.steps)
        (p / "history.json").write_text(json.dumps(history, indent=1))
        print(f"checkpoint -> {p}")
    return history


if __name__ == "__main__":
    main()
