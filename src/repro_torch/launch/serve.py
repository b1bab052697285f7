"""Serving entry point of the port: fused prefill + greedy decode at a
fixed batch and one shared prompt length, and the continuous-batching
serve loop with hot-swapped checkpoints (the twin of the JAX package's
``python -m repro.launch.serve``).

Single-shot:

    python -m repro_torch.launch.serve --arch qwen3-0.6b          # on the card
    python -m repro_torch.launch.serve --arch rwkv6-7b --reduced --device cpu

The path: init the parameters from ``--seed`` (float32, on the device),
``init_cache`` (bfloat16 at full width, float32 for the reduced
configs), one ``prefill_cache`` over the prompt — kernel B6 per dense
layer, kernel B7 per rwkv layer on the card — then ``--gen`` greedy
``decode_step``s.  Prints the prefill and decode rates (host clock
ending in a synchronize; the median of ``--repeat`` passes) and the
kernel launches of each phase, and asserts finite logits.

Continuous batching + hot swap + /metrics (``serving/``):

    python -m repro_torch.launch.serve --arch qwen3-0.6b --serve-loop \
        --requests 16 --max-batch 8 --prompt-len 512 --gen 32 \
        --ckpt-dir runs/ck --metrics-out metrics.txt
    python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \
        --device cpu --serve-loop --requests 8 --max-batch 4

Params come from the newest checkpoint under ``--ckpt-dir`` through a
``HotSwapper`` (its two slots the only parameter copies on the device),
or from ``--seed``.  Prompt lengths and tokens are drawn as the JAX
launcher draws them (``np.random.RandomState(seed)``).  On the card the
decode step is one CUDA graph per parameter slot: the summary line
prints ``decode_graphs=`` where the JAX launcher prints
``decode_compiles=``.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..kernels import ops
from ..models import params as PM
from ..models import transformer as TF


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg, params, prompt, gen: int, max_len: int,
             prefix_embed=None):
    """One prefill + ``gen`` greedy decode steps.  ``prefix_embed``
    [B, P, d]: a stub frontend's embeddings before the prompt (the cache
    then holds P + S + gen positions).  Returns (tokens [B, gen], last
    logits, prefill seconds, decode seconds, launches of each phase)."""
    dev = prompt.device
    B = prompt.shape[0]
    S = prompt.shape[1] + (0 if prefix_embed is None
                           else prefix_embed.shape[1])
    dtype = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    cache = TF.init_cache(cfg, B, max_len, dtype, dev)
    _sync(dev)
    n0 = ops.launches()
    t0 = time.perf_counter()
    logits, cache = TF.prefill_cache(cfg, params, prompt, cache,
                                     prefix_embed)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    n1 = ops.launches()
    toks = []
    t0 = time.perf_counter()
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for i in range(gen):
        toks.append(tok[:, 0])
        logits, cache = TF.decode_step(cfg, params, cache, tok, S + i)
        tok = torch.argmax(logits.reshape(B, -1), dim=-1)[:, None]
    _sync(dev)
    t_gen = time.perf_counter() - t0
    n2 = ops.launches()
    launches = {"prefill": {k: n1[k] - n0[k] for k in n0},
                "decode": {k: n2[k] - n1[k] for k in n0}}
    out = torch.stack(toks, dim=1) if toks else prompt[:, :0]
    return out, logits, t_prefill, t_gen, launches


def meta_params(cfg):
    """The parameter tree of ``cfg`` as shapes only (``meta`` tensors):
    the ``like`` a :class:`HotSwapper` restores into, so that its two
    slots are the only parameter copies on the device."""
    return PM.tree_map_defs(lambda d: torch.empty(d.shape, device="meta"),
                            TF.param_defs(cfg))


def run_serve_loop(args, cfg, dev):
    """Continuous batching over a synthetic request stream; params come
    from the newest checkpoint under --ckpt-dir (hot-swapped live) or
    from --seed.  Returns a dict: the submitted requests (``stream``,
    ``[(prompt, max_new)]`` in rid order), the finished ones (``done``),
    the loop itself (``loop``), its counters and rates."""
    from ..serving import HotSwapper, ServeLoop, latest_row

    max_len = args.max_len or (args.prompt_len + args.gen)
    if args.ckpt_dir:
        swapper = HotSwapper(args.ckpt_dir, like=meta_params(cfg),
                             device=dev)
        loop = ServeLoop(cfg, args.max_batch, max_len, swapper=swapper)
        print(f"serving checkpoint step {swapper.loaded_step} "
              f"from {args.ckpt_dir}")
    else:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        loop = ServeLoop(cfg, args.max_batch, max_len,
                         params=PM.init_params(TF.param_defs(cfg), gen,
                                               device=dev))

    rng = np.random.RandomState(args.seed)
    stream = []
    for _ in range(args.requests):
        plen = rng.randint(max(2, args.prompt_len // 2), args.prompt_len + 1)
        stream.append((rng.randint(0, cfg.vocab, size=plen), args.gen))
        loop.submit(*stream[-1])
    n0 = ops.launches()
    t0 = time.perf_counter()
    done = loop.run()
    secs = time.perf_counter() - t0
    n1 = ops.launches()
    if len(done) != args.requests:
        raise RuntimeError(f"dropped requests: {args.requests} submitted, "
                           f"{len(done)} done")
    n_tok = sum(len(v) for v in done.values())
    decode_s = sum(loop.metrics.step_lat_s)
    print(f"arch={cfg.name} requests={args.requests} "
          f"max_batch={args.max_batch} tokens={n_tok} "
          f"({n_tok / max(secs, 1e-9):.0f} tok/s) steps={loop.steps} "
          f"decode_graphs={loop.decode_graphs()}")
    if loop.swapper:
        print(f"swaps={loop.swapper.swap_count} "
              f"(serving step {loop.swapper.loaded_step})")
    train_row = latest_row(args.ckpt_dir) if args.ckpt_dir else None
    metrics = loop.metrics.render(train_row)
    print(metrics, end="")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(metrics)
        print(f"metrics -> {args.metrics_out}")
    return {"stream": stream, "done": done, "loop": loop,
            "requests": args.requests,
            "max_batch": args.max_batch, "max_len": max_len,
            "tokens": n_tok, "seconds": secs, "tok_s": n_tok / secs,
            "steps": loop.steps, "decode_s": decode_s,
            "decode_tokens": loop.metrics.tokens,
            "decode_tok_s": loop.metrics.tokens / max(decode_s, 1e-12),
            "decode_graphs": loop.decode_graphs(),
            "prefill_shapes": loop.prefill_shapes(),
            "prefills": loop.metrics.prefills,
            "launches": {k: n1[k] - n0[k] for k in n0 if n1[k] != n0[k]}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0,
                    help="cache length; default prompt+gen")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--repeat", type=int, default=1,
                    help="timed prefill+decode passes; the rates printed "
                         "are their medians")
    ap.add_argument("--serve-loop", action="store_true",
                    help="continuous-batching scheduler instead of the "
                         "fixed-batch single shot")
    ap.add_argument("--requests", type=int, default=8,
                    help="[serve-loop] synthetic request count")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="[serve-loop] decode slot count")
    ap.add_argument("--ckpt-dir", default=None,
                    help="[serve-loop] serve (and hot-swap) checkpoints "
                         "from this directory")
    ap.add_argument("--metrics-out", default=None,
                    help="[serve-loop] write the /metrics dump here")
    return ap.parse_args(argv)


def single_shot(args, cfg, dev):
    """Params from --seed, one prompt of [--batch, --prompt-len] tokens,
    --repeat passes of :func:`generate`.  Returns a dict: the median
    rates, the launches of the last pass's phases, its tokens."""
    max_len = args.max_len or (args.prompt_len + args.gen)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = PM.init_params(TF.param_defs(cfg), gen, device=dev)
    B = args.batch
    prompt = torch.randint(0, cfg.vocab, (B, args.prompt_len), generator=gen,
                           device=dev)
    runs = [generate(cfg, params, prompt, args.gen, max_len)
            for _ in range(max(1, args.repeat))]
    toks, logits, _, _, launches = runs[-1]
    t_prefill = statistics.median(r[2] for r in runs)
    t_gen = statistics.median(r[3] for r in runs)
    result = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "batch": B,
        "prompt_len": args.prompt_len, "gen": args.gen,
        "device": str(dev), "repeat": len(runs),
        "prefill_s": t_prefill, "decode_s": t_gen,
        "prefill_tok_s": B * args.prompt_len / t_prefill,
        "decode_tok_s": B * args.gen / t_gen if args.gen else 0.0,
        "launches": launches, "tokens": toks.cpu(),
        "logits_finite": bool(torch.isfinite(logits).all()),
    }
    print(f"arch={cfg.name} layers={cfg.n_layers} B={B} "
          f"prompt={args.prompt_len} gen={args.gen} device={dev}")
    print(f"prefill: {t_prefill:.4f}s ({result['prefill_tok_s']:.0f} tok/s)")
    print(f"decode : {t_gen:.4f}s ({result['decode_tok_s']:.0f} tok/s)")
    for phase in ("prefill", "decode"):
        ran = {k: n for k, n in launches[phase].items() if n}
        print(f"kernel launches in the last {phase}: {ran or 'none'}")
    print("sample tokens:", toks[0][:12].tolist())
    assert result["logits_finite"], "NaN in serving logits"
    return result


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.serve_loop:
        return run_serve_loop(args, cfg, dev)
    return single_shot(args, cfg, dev)


if __name__ == "__main__":
    main()
