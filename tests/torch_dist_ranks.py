"""The rank side of tests/test_torch_distributed.py (and the card's
twins in tests/test_torch_gpu.py): one function that every rank of a
4-rank world runs, and the cases it runs.  No JAX here: the spawned
ranks import this module, and the card's tests import it too.

``run_cases(rank, path_in, out_dir, device, cases)`` builds the flat
mesh (4 workers) and the 2 x 2 data x model mesh (2 workers), then runs,
per mesh, every registered rule through ``engine.aggregate_sharded`` in
"gather", "a2a" and a mixed plan, fixed and elastic; the deterministic
gradient attacks (and gaussian) through ``threat.inject``; and the
reduced qwen3 train step through ``build_train_step(mesh=...)``.  Each
rank writes its outputs (local shards, selection states, per-call
all_gather / all_to_all counts) to ``out_dir/rank{r}.npz``.
"""
import contextlib

import numpy as np
import torch

# mesh name: (shape, axes, global-scope worker count)
MESHES = {"flat": ((4,), ("data",), 4), "dm": ((2, 2), ("data", "model"), 2)}
LEAVES = {"a": (5, 14), "b": (7,), "c": (3, 10)}
# leaf specs on a mesh with a model axis ("a" is split over it; each
# shard [5, 7] pads its own a2a chunk at m = 2)
MODEL_SPECS = {"a": (None, "model"), "b": None, "c": None}
PLAN = ("a2a", "gather", "a2a")            # the mixed plan, leaves a, b, c
LAYOUTS = ("gather", "a2a", "mixed")
VALID = {"flat": [1, 1, 0, 1], "dm": [1, 0]}
INJECT_VALID = {"flat": [1, 1, 0, 1], "dm": [1, 1]}
DETERMINISTIC_ATTACKS = ("alie", "ipm", "negation", "scale", "sign_flip")
INJECT_ALPHA = 0.5
# the train step: reduced qwen3, batch B x S a worker, sgd at lr 1,
# brsgd under sign_flip (one byzantine worker on either mesh)
B, S, STEPS = 2, 32, 2
TRAIN_ALPHA = {"flat": 0.25, "dm": 0.5}
GUARD_ACTIVE = [[1, 1, 1, 1], [1, 1, 0, 1]]
GUARD_FAULTS = [[0, 0, 1, 0], [0, 0, 1, 0]]


def specs_for(mesh_name):
    if MESHES[mesh_name][1] == ("data",):
        return {k: None for k in LEAVES}
    return dict(MODEL_SPECS)


def state_keys(rule: str, elastic: bool) -> tuple:
    """The state fields both packages return for a rule's call."""
    if rule in ("median", "trimmed_mean", "mean"):
        return ("selected",) if elastic else ()
    if rule == "brsgd":
        return ("selected", "scores", "l1", "threshold")
    return ("selected",)


@contextlib.contextmanager
def aggregation_counts():
    """Wrap the train step's ``robust_aggregate`` for the block: yields a
    list that gets, for each call, the all_gather / all_to_all counts of
    that aggregation alone (the losses' and the model shards' gathers
    stand outside it)."""
    from repro_torch.core import collectives
    from repro_torch.training import step as ST
    seen, inner = [], ST.robust_aggregate

    def call(*args, **kw):
        before = collectives.counts()
        out = inner(*args, **kw)
        after = collectives.counts()
        seen.append({k: after[k] - before[k]
                     for k in ("all_gather", "all_to_all")})
        return out
    ST.robust_aggregate = call
    try:
        yield seen
    finally:
        ST.robust_aggregate = inner


def train_cases():
    """name: (mesh, layout, guard)."""
    return {"flat_gather": ("flat", "gather", False),
            "flat_a2a": ("flat", "a2a", False),
            "dm_gather": ("dm", "gather", False),
            "dm_a2a": ("dm", "a2a", False),
            "flat_guard": ("flat", "gather", True)}


def train_config(mesh_name, layout, guard):
    from repro_torch.configs import (ByzantineConfig, RecoveryConfig,
                                     TrainConfig, get_config)
    m = MESHES[mesh_name][2]
    bkw = {"aggregator": "brsgd", "attack": "sign_flip",
           "alpha": TRAIN_ALPHA[mesh_name]}
    if guard:
        bkw.update(max_m=m, quorum=m - 1)
    return TrainConfig(model=get_config("qwen3-0.6b").reduced(),
                       byzantine=ByzantineConfig(**bkw), optimizer="sgd",
                       lr=1.0, grad_clip=0.0, agg_scope="global",
                       agg_layout=layout,
                       recovery=RecoveryConfig(guard=guard))


def tree_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_paths(tree[k], f"{prefix}/{k}")
        return out
    return [prefix]


def params_from(inp, prefix, defs, device):
    from repro_torch.models import params as PM
    paths = tree_paths(defs)
    leaves = [torch.from_numpy(inp[prefix + p].copy()).to(device)
              for p in paths]
    it = iter(leaves)
    return PM.tree_map_defs(lambda d: next(it), defs)


def make_inputs(path):
    """The numpy inputs both packages read, written to ``path``: the
    gradient leaves of each mesh's workers (worker 0 an outlier, so the
    rules select something), the reduced qwen3's params and token
    batches."""
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    rng = np.random.default_rng(7)
    inp = {}
    for name, (_shape, _axes, m) in MESHES.items():
        for k, shp in LEAVES.items():
            g = rng.normal(size=(m,) + shp).astype(np.float32)
            g[0] *= np.float32(-4.0)
            inp[f"{name}/G/{k}"] = g
    cfg = train_config("flat", "gather", False).model
    defs = TF.param_defs(cfg)
    params = PM.init_params(defs, torch.Generator().manual_seed(3))
    for p, x in zip(tree_paths(defs), PM.tree_leaves(params)):
        inp["params" + p] = x.numpy()
    for name, (_shape, _axes, m) in MESHES.items():
        for s in range(STEPS):
            inp[f"{name}/tok/{s}"] = rng.integers(
                0, cfg.vocab, (m, B, S)).astype(np.int32)
    np.savez(path, **inp)
    return inp


def _engine_cases(out, inp, mesh, name, device):
    from repro_torch.configs import ByzantineConfig
    from repro_torch.core import collectives, engine
    from repro_torch.launch.mesh import worker_axes
    from repro_torch.models.params import shard_view
    waxes = worker_axes(mesh)
    maxes = tuple(a for a in mesh.axis_names if a not in waxes)
    me = mesh.index(waxes)
    specs = specs_for(name)
    local = {}
    for k in LEAVES:
        full = inp[f"{name}/G/{k}"][me]
        local[k] = torch.from_numpy(
            full[shard_view(full.shape, specs[k], mesh)].copy()).to(device)
    for layout in LAYOUTS:
        kw = ({"layout": "auto", "plan": PLAN} if layout == "mixed"
              else {"layout": layout})
        for elastic in (False, True):
            valid = np.float32(VALID[name]) if elastic else None
            for rule in engine.registered():
                collectives.reset()
                agg, st = engine.aggregate_sharded(
                    local, ByzantineConfig(aggregator=rule), mesh, waxes,
                    model_axes=maxes, leaf_specs=specs, valid=valid, **kw)
                c = collectives.counts()
                key = f"{name}/{layout}/{int(elastic)}/{rule}"
                for k, v in agg.items():
                    out[f"{key}/agg/{k}"] = v.cpu().numpy().copy()
                for k in state_keys(rule, elastic):
                    out[f"{key}/st/{k}"] = getattr(st, k).cpu().numpy().copy()
                out[f"{key}/collectives"] = np.int64(
                    [c["all_gather"], c["all_to_all"]])
                out[f"{key}/device_types"] = np.array(c["device_types"])


def _inject_cases(out, inp, mesh, name, device):
    from repro_torch.configs import ByzantineConfig
    from repro_torch.core import collectives, threat
    from repro_torch.launch.mesh import worker_axes
    from repro_torch.models.params import shard_view
    from repro_torch.training.step import step_generator
    waxes = worker_axes(mesh)
    maxes = tuple(a for a in mesh.axis_names if a not in waxes)
    me = mesh.index(waxes)
    specs = specs_for(name)
    local = {}
    for k in LEAVES:
        full = inp[f"{name}/G/{k}"][me]
        local[k] = torch.from_numpy(
            full[shard_view(full.shape, specs[k], mesh)].copy()).to(device)
    for elastic in (False, True):
        active = np.float32(INJECT_VALID[name]) if elastic else None
        for attack in DETERMINISTIC_ATTACKS + ("gaussian",):
            cfg = ByzantineConfig(attack=attack, alpha=INJECT_ALPHA)
            collectives.reset()
            got = threat.inject(local, step_generator(0, 0, device), cfg,
                                mesh, waxes, leaf_specs=specs,
                                model_axes=maxes, active=active)
            key = f"{name}/inject/{int(elastic)}/{attack}"
            out[f"{key}/all_reduce"] = np.int64(
                collectives.counts()["all_reduce"])
            for k, v in got.items():
                out[f"{key}/{k}"] = v.cpu().numpy().copy()


def _train_cases(out, inp, meshes, device, cases):
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    from repro_torch.training import build_train_step
    for case in cases:
        name, layout, guard = train_cases()[case]
        mesh = meshes[name]
        tcfg = train_config(name, layout, guard)
        bundle = build_train_step(tcfg, mesh=mesh)
        defs = TF.param_defs(tcfg.model)
        params = params_from(inp, "params", defs, device)
        opt = bundle.opt_init(params)
        for s in range(STEPS):
            args = [params, opt, {"tokens": inp[f"{name}/tok/{s}"]}, s, None]
            if guard:
                args += [np.float32(GUARD_ACTIVE[s]),
                         np.float32(GUARD_FAULTS[s]), -1.0]
            with aggregation_counts() as seen:
                params, opt, met = bundle.step_fn(*args)
            key = f"train/{case}/{s}"
            for k, v in met.items():
                out[f"{key}/met/{k}"] = np.asarray(v, np.float32)
            if mesh.rank == 0:
                for p, x in zip(tree_paths(defs), PM.tree_leaves(params)):
                    # a copy: the step updates params in place
                    out[f"{key}/params{p}"] = x.cpu().numpy().copy()
            out[f"{key}/collectives"] = np.int64(
                [seen[-1]["all_gather"], seen[-1]["all_to_all"]])


def run_cases(rank, path_in, out_dir, device="cpu",
              cases=("engine", "inject", "train"), train=None):
    """Every case of this rank; its outputs to ``out_dir/rank{rank}.npz``.
    Returns the path."""
    from repro_torch.launch.mesh import make_mesh
    torch.manual_seed(0)
    dev = torch.device(device)
    inp = dict(np.load(path_in))
    meshes = {n: make_mesh(shape, axes, device=dev)
              for n, (shape, axes, _m) in MESHES.items()}
    out = {}
    for name, mesh in meshes.items():
        if "engine" in cases:
            _engine_cases(out, inp, mesh, name, dev)
        if "inject" in cases:
            _inject_cases(out, inp, mesh, name, dev)
    if "train" in cases:
        _train_cases(out, inp, meshes, dev,
                     tuple(train_cases()) if train is None else train)
    path = f"{out_dir}/rank{rank}.npz"
    np.savez(path, **out)
    return path
