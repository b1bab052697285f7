"""How often a CPU rank's worker gradient drifts from its fellows'.

Runs ``launch.train.main --mesh 4 --device cpu --reduced`` (qwen3-0.6b
at its reduced config: the CPU side of chip_smoke phase 7i's card = CPU
check) ``--runs`` times, keeps each rank's gradient of step 0 (before
the attack) and compares every rank process with the same rank of the
first run.  ``--float32-cos`` puts torch's float32 CPU cos back into
RoPE (the form before ``models/layers.py:_cos_sin``) and records each
process's largest float32 cos error against float64.  Prints one JSON
line.  Not collected by pytest (no ``test_`` prefix)::

    PYTHONPATH=src python tests/torch_cpu_drift.py --runs 40 [--float32-cos]
"""
import argparse
import functools
import json
import time

import numpy as np

ARGV = ["--arch", "qwen3-0.6b", "--reduced", "--mesh", "4",
        "--agg-layout", "a2a", "--steps", "1", "--batch-per-worker", "2",
        "--seq", "128", "--attack", "sign_flip", "--alpha", "0.25",
        "--optimizer", "sgd", "--lr", "1.0", "--device", "cpu"]
# a drift: a leaf off by more than TOL of its largest magnitude (the
# processes that agree differ by at most ~1e-7, in the embedding's)
TOL = 1e-6


def _rank(float32_cos, rank, args):
    import torch
    import torch.distributed as dist

    from repro_torch.launch import train as TR
    from repro_torch.models import layers
    from repro_torch.training import step as ST
    got = {"cos_err": 0.0}
    if float32_cos:
        def cos_sin(ang):
            c = torch.cos(ang)
            err = float((c.double() - torch.cos(ang.double())).abs().max())
            got["cos_err"] = max(got["cos_err"], err)
            return c, torch.sin(ang)
        layers._cos_sin = cos_sin
    inject = ST.threat.inject

    def keep(local, *a, **kw):
        got.setdefault("grad", [g.detach().numpy().copy() for g in local])
        return inject(local, *a, **kw)
    ST.threat.inject = keep
    TR._mesh_rank(rank, args)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (got["grad"], got["cos_err"]))
    return every if rank == 0 else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=40)
    ap.add_argument("--float32-cos", action="store_true")
    a = ap.parse_args(argv)
    from repro_torch.launch import train as TR
    inner = TR._mesh_rank
    TR._mesh_rank = functools.partial(_rank, a.float32_cos)
    t0 = time.perf_counter()
    base, rel, leaves, cos_err = None, [], [], []
    try:
        for _ in range(a.runs):
            ranks = TR.main(ARGV)
            if base is None:
                base = [g for g, _ in ranks]
            by_leaf = [[float(np.abs(x - y).max() / np.abs(y).max())
                        for x, y in zip(g, b)]
                       for (g, _), b in zip(ranks, base)]
            rel.append([max(r) for r in by_leaf])
            leaves.append([[i for i, e in enumerate(r) if e > TOL]
                           for r in by_leaf])
            cos_err.append([e for _, e in ranks])
    finally:
        TR._mesh_rank = inner
    rel = np.array(rel)
    off = rel > TOL
    # a rank whose first run drifted: most runs differ from it
    for r in range(off.shape[1]):
        if off[1:, r].sum() > (a.runs - 1) / 2:
            off[:, r] = ~off[:, r]
    out = {"runs": a.runs, "float32_cos": a.float32_cos,
           "rank_processes": int(off.size), "drifted": int(off.sum()),
           "largest_rel_diff": float(rel.max()),
           "cos_err_of_drifted": sorted({float(cos_err[i][r])
                                         for i, r in zip(*np.nonzero(off))}),
           "drifted_leaves": [leaves[i][r]
                              for i, r in zip(*np.nonzero(off))],
           "cos_err_max_elsewhere": float(max(
               (cos_err[i][r] for i in range(a.runs)
                for r in range(off.shape[1]) if not off[i, r]),
               default=0.0)),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
