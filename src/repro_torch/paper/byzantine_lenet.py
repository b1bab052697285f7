"""Paper repro (Section 5) on the port: LeNet on FashionMNIST-like data,
m = 20 workers, four attacks — the Fig-3 experiment at example scale
(twin of the JAX package's ``examples/byzantine_lenet.py``): the mean
baseline without attack, then the final accuracy of brsgd, median and
mean under each attack at alpha.

  PYTHONPATH=src python -m repro_torch.paper.byzantine_lenet [--steps 60]
  PYTHONPATH=src python -m repro_torch.paper.byzantine_lenet --device cpu
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    __package__ = "repro_torch.paper"

from . import common  # noqa: E402

ATTACKS = ("gaussian", "negation", "scale", "label_flip")
AGGS = ("brsgd", "median", "mean")


def main(argv=None) -> dict:
    """Prints the table; returns {"baseline": acc, "rows": {attack:
    {aggregator: acc}}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--alpha", type=float, default=0.25)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    base, _ = common.train_lenet("mean", "none", 0.0, steps=args.steps,
                                 device=args.device)
    print(f"attack-free baseline accuracy: {base:.3f}\n")
    print(f"{'attack':<12} {'brsgd':>8} {'median':>8} {'mean':>8}")
    rows = {}
    for attack in ATTACKS:
        rows[attack] = {
            agg: common.train_lenet(agg, attack, args.alpha,
                                    steps=args.steps, device=args.device)[0]
            for agg in AGGS}
        r = rows[attack]
        print(f"{attack:<12} {r['brsgd']:>8.3f} {r['median']:>8.3f} "
              f"{r['mean']:>8.3f}", flush=True)
    print(f"\n(baseline {base:.3f}; paper claim: brsgd column ~ baseline, "
          f"mean column collapses under gaussian/negation)")
    return {"baseline": base, "rows": rows}


if __name__ == "__main__":
    main()
