"""Extended robustness matrix on the port (twin of the JAX package's
``benchmarks/robustness.py``): every gradient and timing attack in the
threat registry × every aggregator in the engine registry, on the
strongly convex regression problem, at quorum q ∈ {m, 0.75m, 0.5m}.

q = m is the classic fixed-m round; q < m (and the ``stall`` attack at
any q) runs the elastic path: a per-step active set from an
ArrivalSchedule, masked apply_dense and masked aggregate_local, with
n_byzantine = ⌊α·n_active⌋.  Reported: final ‖w − w*‖ (lower is
better), and the CLAIM that brsgd stays near the clean error under every
attack at q = m and q = 0.75m while the mean breaks.

  PYTHONPATH=src python -m repro_torch.paper.robustness [--seeds 2]
      [--out FILE] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    __package__ = "repro_torch.paper"

import numpy as np  # noqa: E402

from ..configs.base import ByzantineConfig  # noqa: E402
from ..core import engine, threat  # noqa: E402
from ..data.pipeline import ArrivalSchedule  # noqa: E402
from .common import REG_D, REG_LR, regression_error  # noqa: E402

D, STEPS, LR, M, N = REG_D, 150, REG_LR, 20, 400
# the fixed-m round and the two elastic operating points (0.75m, 0.5m)
QUORUMS = [M, int(0.75 * M), M // 2]
CLAIM_QUORUMS = [M, int(0.75 * M)]
# every gradient-scope attack in the historical column order, any newly
# registered one appended, then the timing-scope attacks (stall)
_ORDER = ["gaussian", "negation", "scale", "sign_flip", "alie", "ipm"]
_GRAD = [n for n in threat.registered()
         if threat.get_spec(n).scope == "gradient"]
_TIMING = sorted(n for n in threat.registered()
                 if threat.get_spec(n).scope == "timing")
ATTACKS = ([a for a in _ORDER if a in _GRAD]
           + sorted(a for a in _GRAD if a not in _ORDER) + _TIMING)
# brsgd first, the non-robust mean last
AGGS = ["brsgd"] + sorted(n for n in engine.registered()
                          if n not in ("brsgd", "mean")) + ["mean"]


def run(agg: str, attack: str, alpha: float = 0.25, seed: int = 0,
        quorum: int = M, device="cuda") -> float:
    """One cell: the final ‖w − w*‖ after STEPS steps.  The fixed-m
    round at q = m; an elastic round per step below it, and under a
    timing attack (stall) at any q."""
    timing = attack != "none" and threat.get_spec(attack).scope == "timing"
    if quorum < M or timing:
        bcfg = ByzantineConfig(aggregator=agg, attack=attack, alpha=alpha,
                               max_m=M, quorum=quorum)
        sched = ArrivalSchedule(M, quorum, byz=bcfg, seed=seed)
    else:
        bcfg = ByzantineConfig(aggregator=agg, attack=attack, alpha=alpha)
        sched = None
    return regression_error(bcfg, M, N, STEPS, seed, device, sched)


def claim(errs: dict, clean: float):
    """(ok, lines) of the robustness claim over errs[(q, agg, attack)]:
    brsgd within 5× clean + 0.1 under every attack at q = m and 0.75m,
    and the mean broken (inf or > 10× clean) by scale or negation at
    q = m."""
    worst = max(errs[(q, "brsgd", a)] for q in CLAIM_QUORUMS
                for a in ATTACKS)
    mean_broken = any(not math.isfinite(errs[(M, "mean", a)])
                      or errs[(M, "mean", a)] > 10 * clean
                      for a in ("scale", "negation"))
    ok = worst < 5 * clean + 0.1 and mean_broken
    return ok, [f"# brsgd worst error {worst:.4f} vs clean {clean:.4f} "
                f"(over quorums {CLAIM_QUORUMS})",
                f"# CLAIM robust to all {len(ATTACKS)} registered attacks "
                f"incl. ALIE/IPM/stall at q=m and q=0.75m: "
                f"{'PASS' if ok else 'FAIL'}"]


def main(device="cuda", seeds: int = 2, out=None) -> int:
    seeds = range(seeds)
    clean = float(np.mean([run("mean", "none", 0.0, s, device=device)
                           for s in seeds]))
    lines = [f"# clean-mean error: {clean:.4f}",
             "quorum,aggregator," + ",".join(ATTACKS)]
    print("\n".join(lines), flush=True)
    errs = {}
    for q in QUORUMS:
        for agg in AGGS:
            row = []
            for attack in ATTACKS:
                e = float(np.mean([run(agg, attack, seed=s, quorum=q,
                                       device=device) for s in seeds]))
                errs[(q, agg, attack)] = e
                row.append("inf" if not math.isfinite(e) else f"{e:.4f}")
            lines.append(f"{q},{agg}," + ",".join(row))
            print(lines[-1], flush=True)
    ok, tail = claim(errs, clean)
    lines += tail
    print("\n".join(tail), flush=True)
    if out:
        Path(out).write_text("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--out", default=None,
                    help="also write the matrix to this file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.exit(main(args.device, args.seeds, args.out))
