"""Serving demo on the port: fused prefill + greedy decode for any
registered architecture, and the end-to-end robust train -> serve loop
(twin of the JAX package's ``examples/serve_demo.py``).

  PYTHONPATH=src python -m repro_torch.paper.serve_demo --arch rwkv6-7b
  PYTHONPATH=src python -m repro_torch.paper.serve_demo --arch minicpm3-4b --full
  PYTHONPATH=src python -m repro_torch.paper.serve_demo --train-and-serve

End to end: train under attack with periodic (atomic) checkpoints, then
serve a request stream while a later checkpoint is published mid-stream;
the server hot-swaps it under live decode and keeps answering (no
dropped request).  The reference's one decode compile is the serve
loop's decode graphs on the card (``ServeLoop.decode_graphs()``: one per
parameter slot decoded with, so 2 across the swap; the CPU runs the
step eagerly, 0 graphs).  Every argv handed to
``launch.train.main`` / ``launch.serve.main`` is the example's, with
``--workers`` (training) and ``--device`` added.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    __package__ = "repro_torch.paper"


def publish(src_dir, dst_dir, step):
    """Copy one checkpoint between directories, manifest LAST so a
    concurrently-polling HotSwapper never sees a torn step."""
    os.makedirs(dst_dir, exist_ok=True)
    name = f"step_{step:08d}"
    for ext in (".npz", ".json"):          # manifest-last protocol
        tmp = os.path.join(dst_dir, name + ext + ".tmp")
        shutil.copy(os.path.join(src_dir, name + ext), tmp)
        os.rename(tmp, os.path.join(dst_dir, name + ext))


def train_and_serve(args) -> dict:
    """Train under attack with checkpointing; serve with a hot swap
    mid-stream.  Deterministic: training finishes first, the swap is
    forced by publishing a later checkpoint from the decode loop."""
    import numpy as np

    from .. import resolve_device
    from ..configs import get_config
    from ..launch import train as T
    from ..launch.serve import meta_params
    from ..serving import HotSwapper, ServeLoop, latest_row

    dev = resolve_device(args.device)
    stage = tempfile.mkdtemp(prefix="repro_stage_")
    live = tempfile.mkdtemp(prefix="repro_live_")
    try:
        steps = 5
        T.main(["--arch", args.arch, "--reduced", "--steps", str(steps),
                "--seq", "32", "--batch-per-worker", "1",
                "--attack", "sign_flip", "--alpha", "0.25",
                "--ckpt-dir", stage, "--ckpt-every", "2",
                "--workers", str(args.workers), "--device", args.device])
        shutil.copy(os.path.join(stage, "telemetry.jsonl"),
                    os.path.join(live, "telemetry.jsonl"))
        publish(stage, live, 2)                # serve starts on step 2

        cfg = get_config(args.arch).reduced()
        swapper = HotSwapper(live, like=meta_params(cfg), device=dev)
        assert swapper.loaded_step == 2
        loop = ServeLoop(cfg, max_batch=4,
                         max_len=args.prompt_len + args.gen, swapper=swapper)
        rng = np.random.RandomState(args.seed)
        for _ in range(8):
            plen = rng.randint(3, args.prompt_len + 1)
            loop.submit(rng.randint(0, cfg.vocab, size=plen),
                        max_new=args.gen)

        def on_step(lp, s):
            if s == 3:                         # force a swap under live decode
                publish(stage, live, steps)

        done = loop.run(on_step=on_step)
        assert len(done) == 8, f"dropped requests: {8 - len(done)}"
        assert swapper.swap_count >= 1, "no hot swap happened"
        assert swapper.loaded_step == steps
        # the reference compiles its decode step once for both parameter
        # trees; the card captures one graph per parameter slot the loop
        # decoded with (step 2's, then the swapped-in one's), the CPU none
        graphs = min(2, 1 + swapper.swap_count) if dev.type == "cuda" else 0
        assert loop.decode_graphs() == graphs, \
            f"decode graphs: {loop.decode_graphs()}, want {graphs}"
        print(f"train->serve OK: 8/8 requests, {swapper.swap_count} "
              f"swap(s), {loop.decode_graphs()} decode graph(s), serving "
              f"step {swapper.loaded_step}")
        print(loop.metrics.render(latest_row(live)), end="")
        return {"done": done, "swap_count": swapper.swap_count,
                "loaded_step": swapper.loaded_step,
                "decode_graphs": loop.decode_graphs(), "loop": loop}
    finally:
        shutil.rmtree(stage, ignore_errors=True)
        shutil.rmtree(live, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="run the full (non-reduced) config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-and-serve", action="store_true",
                    help="end-to-end: train under attack with "
                         "checkpointing, serve across a live hot swap")
    ap.add_argument("--workers", type=int, default=8,
                    help="[train-and-serve] simulated workers on the one "
                         "device (the example's 8 host devices)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.train_and_serve:
        return train_and_serve(args)

    from ..launch import serve as S
    argv = ["--arch", args.arch, "--batch", str(args.batch),
            "--prompt-len", str(args.prompt_len), "--gen", str(args.gen),
            "--seed", str(args.seed)]
    if not args.full:
        argv.append("--reduced")
    return S.main(argv + ["--device", args.device])


if __name__ == "__main__":
    main()
