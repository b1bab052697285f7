"""Theorem 1's statistical rate on the port (twin of the JAX package's
``benchmarks/rate.py``): ‖w_T − w*‖ = O(1/√n + 1/√(nm)) for the strongly
convex least-squares loss, robust to α < 1/2 byzantine workers.

Each of m workers holds n samples; BrSGD runs under a scale attack
(factor 50) at α = 0.2.  Checked: the error falls like n^-1/2 at m = 20,
and under attack it stays near the clean mean's while the attacked mean
is far off.

  PYTHONPATH=src python -m repro_torch.paper.rate [--device cuda|cpu]
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

STEPS = 150
MS = (10, 20)
NS = (50, 200, 800, 3200)


def run(m: int, n: int, aggregator: str, alpha: float, seed: int = 0,
        device="cuda") -> float:
    bcfg = ByzantineConfig(aggregator=aggregator, attack="scale",
                           alpha=alpha, scale_factor=50.0)
    return regression_error(bcfg, m, n, STEPS, seed, device)


def main(device="cuda") -> int:
    print("m,n,aggregator,alpha,error")
    errs = {}
    for m in MS:
        for n in NS:
            for agg, alpha in (("brsgd", 0.2), ("mean", 0.2), ("mean", 0.0)):
                e = float(np.mean([run(m, n, agg, alpha, s, device)
                                   for s in range(3)]))
                errs[(m, n, agg, alpha)] = e
                print(f"{m},{n},{agg},{alpha},{e:.4f}", flush=True)
    ns = np.asarray(NS, float)
    es = np.asarray([errs[(20, int(n), "brsgd", 0.2)] for n in ns])
    slope = np.polyfit(np.log(ns), np.log(es), 1)[0]
    print(f"# brsgd error ~ n^{slope:.2f}  (theory: -0.5)")
    ok_rate = -0.75 < slope < -0.25
    e_brsgd = errs[(20, 800, "brsgd", 0.2)]
    e_clean = errs[(20, 800, "mean", 0.0)]
    e_mean = errs[(20, 800, "mean", 0.2)]
    print(f"# attack m=20 n=800: brsgd={e_brsgd:.4f} clean-mean={e_clean:.4f} "
          f"attacked-mean={e_mean:.4f}")
    mean_broken = (not np.isfinite(e_mean)) or e_mean > 3 * e_brsgd
    ok_rob = e_brsgd < 5 * e_clean + 0.05 and mean_broken
    ok = ok_rate and ok_rob
    print(f"# CLAIM order-optimal rate + robustness: "
          f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    sys.exit(main(ap.parse_args().device))
