"""Quickstart on the port: the BrSGD aggregation rule on the card (twin
of the JAX package's ``examples/quickstart.py``).

Builds a worker-gradient matrix G for a toy problem, corrupts 25% of
the rows with the paper's Gradient Scale attack, and shows that mean()
is destroyed while brsgd() recovers the honest mean.

  PYTHONPATH=src python -m repro_torch.paper.quickstart
  python src/repro_torch/paper/quickstart.py
"""
from __future__ import annotations

import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    __package__ = "repro_torch.paper"

import numpy as np  # noqa: E402
import torch  # noqa: E402

from .. import resolve_device  # noqa: E402
from ..configs.base import ByzantineConfig  # noqa: E402
from ..core import aggregators, threat  # noqa: E402


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    m, d = 20, 1_000
    rng = np.random.default_rng(0)
    # honest workers: gradient = true_grad + noise
    true_grad = rng.normal(size=d).astype("f4")
    G = torch.as_tensor(true_grad[None]
                        + 0.1 * rng.normal(size=(m, d)).astype("f4"),
                        device=dev)
    bcfg = ByzantineConfig(aggregator="brsgd", attack="scale", alpha=0.25,
                           scale_factor=1e10)
    gen = torch.Generator(device=dev).manual_seed(0)
    G_attacked = threat.apply_dense(G, gen, bcfg)

    naive = aggregators.mean(G_attacked)
    robust, state = aggregators.brsgd(G_attacked, bcfg, return_state=True)
    truth = torch.as_tensor(true_grad, device=dev)

    def err(v):
        return float(torch.linalg.vector_norm(v - truth))

    selected = torch.nonzero(state.selected).flatten().tolist()
    print(f"workers m={m}, dims d={d}, byzantine={int(0.25 * m)}, "
          f"device={dev}")
    print(f"naive mean error : {err(naive):.3e}   <- destroyed by one attack")
    print(f"brsgd error      : {err(robust):.3e}")
    print(f"selected workers : {selected}")
    print(f"l1-filter kept   : {int(state.c1.sum())}, score-filter kept: "
          f"{int(state.c2.sum())} (beta={bcfg.beta})")
    if not err(robust) < 1.0 < err(naive):
        raise AssertionError("BrSGD did not recover the honest gradient")
    print("OK: BrSGD recovered the honest gradient.")
    return {"naive_err": err(naive), "brsgd_err": err(robust),
            "selected": selected}


if __name__ == "__main__":
    main()
