"""Training entry point of the port: BrSGD with m simulated workers on one
device (the twin of the JAX package's ``python -m repro.launch.train``,
whose ``--mesh`` becomes ``--workers``: one card holds every worker, as
the port's paper loop does).

    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 20 \
        --attack sign_flip --alpha 0.25                  # on the card
    python -m repro_torch.launch.train --reduced --device cpu --workers 8

``--quorum`` / ``--straggle`` run elastic rounds (an ``ArrivalSchedule``
picks each step's active workers), ``--supervise`` the guarded step under
the recovery supervisor, ``--ckpt-dir`` / ``--ckpt-every`` save the
port's checkpoints (the JAX package's format) with a telemetry row per
logged step beside them.  Params are float32, drawn from the config's
seed.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-per-worker", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--workers", type=int, default=20,
                    help="simulated workers m on the one device (the "
                         "paper's m = 20; the JAX launcher's mesh size)")
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
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    from .. import resolve_device
    from ..checkpoint import ckpt
    from ..configs import (ByzantineConfig, RecoveryConfig, TrainConfig,
                           get_config)
    from ..core import engine, threat
    from ..data.pipeline import (ArrivalSchedule, LMWorkerPipeline,
                                 parse_straggle)
    from ..faults import Supervisor
    from ..models import params as PM
    from ..models import transformer as TF
    from ..serving import telemetry
    from ..training.step import build_train_step, step_generator

    if args.aggregator not in engine.registered():
        ap.error(f"--aggregator {args.aggregator!r}: "
                 f"choose from {', '.join(engine.registered())}")
    if args.attack != "none" and args.attack not in threat.registered():
        ap.error(f"--attack {args.attack!r}: choose from none, "
                 f"{', '.join(threat.registered())}")
    try:
        straggle, straggle_scale = parse_straggle(args.straggle)
    except ValueError as e:
        ap.error(f"--straggle {args.straggle!r}: {e}")
    dev = resolve_device(args.device)
    m = args.workers
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

    bundle = build_train_step(tcfg, m, dev)
    defs = TF.param_defs(cfg)
    print(f"device={dev} workers={m} scope={bundle.scope} arch={cfg.name} "
          f"params={PM.count_params(defs):,}")
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
            print(f"step {step:4d} loss={met['loss']:.4f} "
                  f"gnorm={met['gnorm']:.3f} "
                  f"selected={met['n_selected']:.1f}/{m} "
                  f"(bucket min {met['n_selected_min']:.0f})" + act_s,
                  flush=True)
            if args.ckpt_dir:
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
        if (args.ckpt_dir and args.ckpt_every
                and (step + 1) % args.ckpt_every == 0):
            if sup is not None:
                sup.checkpoint(params, step + 1)
            else:
                ckpt.save(args.ckpt_dir, params, step=step + 1)

    dt = time.time() - t_start
    tok = args.steps * m * args.batch_per_worker * args.seq
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
