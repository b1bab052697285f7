"""Ablation of the paper's two hyperparameters on the port (twin of the
JAX package's ``benchmarks/ablation.py``): the kept fraction β
(Constraint 2) and the l1 threshold 𝔗 (Constraint 1, auto or off).

The rate.py regression under a 20% scale attack (factor 50).  Expected:
β inside (α, 1/2] is robust with a flat error; β = 1 leaves the l1
filter alone to defend; a huge fixed 𝔗 with β = 1 is the broken mean.

  PYTHONPATH=src python -m repro_torch.paper.ablation [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    __package__ = "repro_torch.paper"

import numpy as np  # noqa: E402

from ..configs.base import ByzantineConfig  # noqa: E402
from .common import regression_error  # noqa: E402

STEPS, M, N = 120, 20, 400
BETAS = (0.3, 0.4, 0.5, 0.75, 1.0)
THRESHOLDS = (0.0, 1e9)        # 0.0 = auto (lower quartile); 1e9 = off


def run(bcfg: ByzantineConfig, seed: int = 0, device="cuda") -> float:
    return regression_error(bcfg, M, N, STEPS, seed, device)


def main(device="cuda") -> int:
    print("beta,threshold,error")
    results = {}
    for beta in BETAS:
        for thr in THRESHOLDS:
            bcfg = ByzantineConfig(aggregator="brsgd", beta=beta,
                                   threshold=thr, attack="scale", alpha=0.2,
                                   scale_factor=50.0)
            e = float(np.mean([run(bcfg, s, device) for s in range(3)]))
            results[(beta, thr)] = e
            print(f"{beta},{'auto' if thr == 0 else 'off'},{e:.4f}",
                  flush=True)
    valid = [results[(b, 0.0)] for b in (0.3, 0.4, 0.5)]
    spread = max(valid) / max(min(valid), 1e-9)
    print(f"# beta-insensitivity inside (alpha, 1/2]: spread x{spread:.2f}")
    both_off = results[(1.0, 1e9)]
    l1_only = results[(1.0, 0.0)]
    score_only = results[(0.5, 1e9)]
    print(f"# l1-only error {l1_only:.3f}; score-only {score_only:.3f}; "
          f"both-off (mean) {both_off:.3f}")
    ok = spread < 3.0 and both_off > 5 * max(l1_only, score_only, 1e-3)
    print(f"# CLAIM both constraints contribute, valid-range insensitive: "
          f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    sys.exit(main(ap.parse_args().device))
