"""Paper Fig. 3 on the port (twin of the JAX package's
``benchmarks/fig3.py``): LeNet test accuracy against the step, per
aggregator, under each attack at α = 25%, printed as CSV.

  PYTHONPATH=src python -m repro_torch.paper.fig3 [steps]
"""
from __future__ import annotations

import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    __package__ = "repro_torch.paper"

from .common import train_lenet  # noqa: E402

ATTACKS = ["gaussian", "negation", "scale", "label_flip"]
AGGS = ["brsgd", "median", "mean"]


def main(steps: int = 60, device="cuda") -> int:
    print("aggregator,attack,step,accuracy")
    _, base_curve = train_lenet("mean", "none", 0.0, steps=steps,
                                device=device)
    for s, a in base_curve:
        print(f"mean,none,{s},{a:.3f}")
    for agg in AGGS:
        for attack in ATTACKS:
            _, curve = train_lenet(agg, attack, 0.25, steps=steps,
                                   device=device)
            for s, a in curve:
                print(f"{agg},{attack},{s},{a:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 60))
