"""End to end on the port: BrSGD training of a qwen3-family LM with
simulated Byzantine workers (twin of the JAX package's
``examples/train_100m.py``).

Default: the reduced model, 30 steps of 2 x 128 tokens a worker.
``--full`` registers a ~100M-parameter qwen3-family config (``qwen3-100m``:
12 layers, d_model 768, d_ff 2048, vocab 32768, 12 / 4 heads of 64; D =
100,684,032) and trains it for 300 steps of 4 x 512 tokens a worker.
Both run gaussian noise on 25% of the workers under BrSGD and assert that
the loss falls.  The argv handed to ``launch.train.main`` is the
example's, with ``--workers`` (the simulated workers on one device, the
example's 8 host devices) and ``--device`` added.

  PYTHONPATH=src python -m repro_torch.paper.train_100m --full   # the card
  PYTHONPATH=src python -m repro_torch.paper.train_100m --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    __package__ = "repro_torch.paper"


def full_config():
    """The ~100M-parameter qwen3-family config of ``--full``."""
    from .. import configs
    base = configs.get_config("qwen3-0.6b")
    return dataclasses.replace(
        base, name="qwen3-100m", n_layers=12, d_model=768, d_ff=2048,
        vocab=32768,
        attention=dataclasses.replace(base.attention, n_heads=12,
                                      n_kv_heads=4, head_dim=64))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params, 300 steps, seq 512")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--attack", default="gaussian")
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--ckpt-dir", default="results/train_100m")
    ap.add_argument("--workers", type=int, default=8,
                    help="simulated workers on the one device (the "
                         "example's 8 host devices)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from ..launch import train as T

    if args.full:
        # registered on the fly, as the example does, so the stock
        # launcher can select it
        from .. import configs
        configs.ARCHS["qwen3-100m"] = full_config()
        argv = ["--arch", "qwen3-100m", "--steps", str(args.steps or 300),
                "--batch-per-worker", "4", "--seq", "512"]
    else:
        argv = ["--arch", "qwen3-0.6b", "--reduced",
                "--steps", str(args.steps or 30),
                "--batch-per-worker", "2", "--seq", "128"]
    argv += ["--attack", args.attack, "--alpha", str(args.alpha),
             "--aggregator", "brsgd", "--ckpt-dir", args.ckpt_dir,
             "--workers", str(args.workers), "--device", args.device]
    history = T.main(argv)
    losses = [h["loss"] for h in history]
    assert losses[-1] < losses[0], f"no training progress: {losses}"
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} under "
          f"{args.attack}@{args.alpha:.0%} with BrSGD aggregation")
    return history


if __name__ == "__main__":
    main()
