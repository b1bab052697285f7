"""The port's torch.distributed layouts against the JAX package's
shard_map ones, on the CPU: ``engine.aggregate_sharded`` (gather, a2a and
a mixed plan), ``distributed.robust_aggregate``, ``threat.inject`` and
the global train step with one rank a worker (``build_train_step(mesh=)``).

One jitted 4-device JAX subprocess (``conftest.run_multidevice`` with
``tests/meshes.py``'s preamble for "flat" at m = 4 and "dm" at m = 2)
writes every reference output to one npz, while one 4-rank gloo spawn of
the port (``launch.mesh.launch``, one torch thread a rank,
``tests/torch_dist_ranks.py``) runs the same cases on the same numpy
arrays; the two run at once.

Inputs: a [5, 14] leaf split over 'model' on dm (each [5, 7] shard pads
its own a2a chunk at m = 2), a replicated [7] leaf and a [3, 10] leaf
(m = 4 does not divide either: the a2a pads).  Tolerances:
* scores, selections and masks exact (no count here reaches 2^24);
  aggregates and the attacked leaves within 1e-6 of their largest
  magnitude (the reduction orders differ; ALIE adds the float32
  uncertainty of its cancelling variance, ``_alie_slack``); l1 and 𝔗
  within 1e-6 relative;
* the all_gather / all_to_all counts of every call equal
  ``engine.expected_collectives``, which equals the reference's;
* the train step's params within 1e-5 of the step's max|Δp| of JAX's
  ``build_train_step`` on the same mesh and of the port's single-device
  step at the mesh's m; ``n_selected`` equal; loss, ce, gnorm within
  1e-5 relative.
"""
import math
import textwrap
import threading

import numpy as np
import pytest
import torch

import meshes
import torch_dist_ranks as R
from repro_torch.configs import ByzantineConfig
from repro_torch.core import engine, threat
from repro_torch.launch import mesh as MM
from repro_torch.launch.train import main as train_main
from repro_torch.models import params as PM
from repro_torch.models import transformer as TF
from repro_torch.training import build_train_step

AGG_TOL = 1e-6
PARAM_TOL = 1e-5
REL_TOL = 1e-5

_SNIPPET = textwrap.dedent("""
    import jax, jax.numpy as jnp, numpy as np
    from functools import partial
    from repro.compat import shard_map, P
    from repro.configs import ByzantineConfig, RecoveryConfig, TrainConfig
    from repro.configs import get_config
    from repro.core import engine, threat
    from repro.core.distributed import robust_aggregate
    from repro.models import params as PM, transformer as TF
    from repro.training.step import build_train_step

    inp = dict(np.load(%(IN)r))
    LEAVES = %(LEAVES)r
    PLAN = %(PLAN)r
    LAYOUTS = %(LAYOUTS)r
    VALID = %(VALID)r
    INJECT_VALID = %(INJECT_VALID)r
    ATTACKS = %(ATTACKS)r
    INJECT_ALPHA = %(INJECT_ALPHA)r
    TRAIN = %(TRAIN)r
    TRAIN_ALPHA = %(TRAIN_ALPHA)r
    GUARD_ACTIVE, GUARD_FAULTS = %(GUARD_ACTIVE)r, %(GUARD_FAULTS)r
    STEPS = %(STEPS)d
    RULES = engine.registered()
    out = {}

    def state_keys(rule, elastic):
        if rule in ("median", "trimmed_mean", "mean"):
            return ("selected",) if elastic else ()
        if rule == "brsgd":
            return ("selected", "scores", "l1", "threshold")
        return ("selected",)

    # the reference's expected collectives, every (rule, layout, leaves)
    for rule in RULES:
        spec = engine.get_spec(rule)
        for layout in ("local", "gather", "a2a"):
            for n in (1, 3, 7):
                c = engine.expected_collectives(spec, layout, n)
                out[f"expected/{rule}/{layout}/{n}"] = np.int64(
                    [c["all_gather"], c["all_to_all"]])
        c = engine.expected_collectives(spec, "auto", 3, plan=PLAN)
        out[f"expected/{rule}/auto/3"] = np.int64(
            [c["all_gather"], c["all_to_all"]])
    for attack in ATTACKS + ("gaussian", "label_flip"):
        for n in (1, 3):
            c = threat.inject_collectives(
                ByzantineConfig(attack=attack, alpha=INJECT_ALPHA), n, 4)
            out[f"inject_expected/{attack}/{n}"] = np.int64(
                [c["all_reduce"], c["axis_index"]])

    for name, mm in (("flat", 4), ("dm", 2)):
        exec(PREAMBLES[name])
        specs = {k: P() for k in LEAVES}
        if MAXES:
            specs["a"] = P(None, "model")
        gspecs = {k: P(wspec, *([None] * len(LEAVES[k]) if not MAXES or
                                k != "a" else [None, "model"]))
                  for k in LEAVES}
        aspecs = {k: (P(None, "model") if MAXES and k == "a" else P())
                  for k in LEAVES}
        G = {k: jnp.asarray(inp[f"{name}/G/{k}"]) for k in LEAVES}
        for layout in LAYOUTS:
            kw = (dict(layout="auto", plan=PLAN) if layout == "mixed"
                  else dict(layout=layout))
            for elastic in (False, True):
                ospec = {r: (aspecs, {k: P() for k in state_keys(r, elastic)})
                         for r in RULES}

                @jax.jit
                @partial(shard_map, mesh=mesh, in_specs=(gspecs, P()),
                         out_specs=ospec, axis_names=set(AXES))
                def body(gs, valid):
                    local = {k: v.reshape(v.shape[1:]) for k, v in gs.items()}
                    res = {}
                    for r in RULES:
                        agg, st = engine.aggregate_sharded(
                            local, ByzantineConfig(aggregator=r), WAXES,
                            flatten_columns=True, model_axes=MAXES,
                            leaf_specs=specs,
                            valid=valid if elastic else None, **kw)
                        res[r] = (agg, {k: getattr(st, k)
                                        for k in state_keys(r, elastic)})
                    return res

                res = body(G, jnp.float32(VALID[name]))
                for r, (agg, st) in res.items():
                    key = f"{name}/{layout}/{int(elastic)}/{r}"
                    for k, v in agg.items():
                        out[f"{key}/agg/{k}"] = np.asarray(v)
                    for k, v in st.items():
                        out[f"{key}/st/{k}"] = np.asarray(v)
            # robust_aggregate: brsgd, this layout, fixed
            if layout != "mixed":
                @jax.jit
                @partial(shard_map, mesh=mesh, in_specs=(gspecs,),
                         out_specs=aspecs, axis_names=set(AXES))
                def ra(gs):
                    local = {k: v.reshape(v.shape[1:]) for k, v in gs.items()}
                    return robust_aggregate(
                        local, ByzantineConfig(aggregator="brsgd"), WAXES,
                        layout=layout, flatten_columns=True,
                        model_axes=MAXES, leaf_specs=specs)[0]
                for k, v in ra(G).items():
                    out[f"{name}/robust/{layout}/{k}"] = np.asarray(v)
        for elastic in (False, True):
            @jax.jit
            @partial(shard_map, mesh=mesh, in_specs=(gspecs, P()),
                     out_specs={a: gspecs for a in ATTACKS},
                     axis_names=set(AXES))
            def inj(gs, active):
                local = {k: v.reshape(v.shape[1:]) for k, v in gs.items()}
                res = {}
                for a in ATTACKS:
                    got = threat.inject(
                        local, jax.random.PRNGKey(0),
                        ByzantineConfig(attack=a, alpha=INJECT_ALPHA), WAXES,
                        leaf_specs=specs, model_axes=MAXES,
                        active=active if elastic else None)
                    res[a] = {k: v[None] for k, v in got.items()}
                return res
            for a, got in inj(G, jnp.float32(INJECT_VALID[name])).items():
                for k, v in got.items():
                    out[f"{name}/inject/{int(elastic)}/{a}/{k}"] = np.asarray(v)

        cfg = get_config("qwen3-0.6b").reduced()
        defs = TF.param_defs(cfg)
        for case, (mname, layout, guard) in TRAIN.items():
            if mname != name:
                continue
            bkw = dict(aggregator="brsgd", attack="sign_flip",
                       alpha=TRAIN_ALPHA[name])
            if guard:
                bkw.update(max_m=m, quorum=m - 1)
            tcfg = TrainConfig(model=cfg, byzantine=ByzantineConfig(**bkw),
                               optimizer="sgd", lr=1.0, grad_clip=0.0,
                               agg_scope="global", agg_layout=layout,
                               recovery=RecoveryConfig(guard=guard))
            bundle = build_train_step(tcfg, mesh)
            psh, osh, bsh = bundle.shardings(mesh)
            leaves, tdef = jax.tree.flatten(
                defs, is_leaf=lambda x: isinstance(x, PM.ParamDef))
            paths = [p for p in PATHS]
            params = jax.tree.unflatten(
                tdef, [jnp.asarray(inp["params" + p]) for p in paths])
            opt = ()
            for s in range(STEPS):
                args = [jax.device_put(params, psh), jax.device_put(opt, osh),
                        {"tokens": jax.device_put(
                            jnp.asarray(inp[f"{name}/tok/{s}"]),
                            bsh["tokens"])},
                        jnp.int32(s),
                        jax.random.fold_in(jax.random.PRNGKey(0), s)]
                if guard:
                    args += [jnp.float32(GUARD_ACTIVE[s]),
                             jnp.float32(GUARD_FAULTS[s]), jnp.float32(-1.0)]
                with mesh:
                    params, opt, met = bundle.step_fn(*args)
                for k, v in met.items():
                    out[f"train/{case}/{s}/met/{k}"] = np.asarray(v)
                for p, x in zip(paths, jax.tree.leaves(params)):
                    out[f"train/{case}/{s}/params{p}"] = np.asarray(x)
    np.savez(%(OUT)r, **out)
    print("OK")
""")


def _run_jax(path_in, path_out, box):
    defs = TF.param_defs(R.train_config("flat", "gather", False).model)
    pre = {name: meshes.preamble(name, m)
           for name, (_s, _a, m) in R.MESHES.items()}
    code = ("PREAMBLES = " + repr(pre) + "\nPATHS = "
            + repr(R.tree_paths(defs)) + "\n"
            + _SNIPPET % {
                "IN": path_in, "OUT": path_out, "LEAVES": R.LEAVES,
                "PLAN": R.PLAN, "LAYOUTS": R.LAYOUTS, "VALID": R.VALID,
                "INJECT_VALID": R.INJECT_VALID,
                "ATTACKS": R.DETERMINISTIC_ATTACKS,
                "INJECT_ALPHA": R.INJECT_ALPHA, "TRAIN": R.train_cases(),
                "TRAIN_ALPHA": R.TRAIN_ALPHA,
                "GUARD_ACTIVE": R.GUARD_ACTIVE,
                "GUARD_FAULTS": R.GUARD_FAULTS, "STEPS": R.STEPS})
    try:
        from conftest import run_multidevice
        box["stdout"] = run_multidevice(code, n_devices=4, timeout=560)
    except BaseException as e:          # re-raised in the fixture
        box["error"] = e


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX outputs, the port's per-rank outputs): the JAX
    subprocess and the port's 4 ranks run at once."""
    d = tmp_path_factory.mktemp("distributed")
    path_in = str(d / "inputs.npz")
    inp = R.make_inputs(path_in)
    box = {}
    th = threading.Thread(target=_run_jax,
                          args=(path_in, str(d / "jax.npz"), box))
    th.start()
    try:
        paths = MM.launch(R.run_cases, 4, (path_in, str(d)), device="cpu",
                          threads=1, timeout_s=600)
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    assert "OK" in box["stdout"]
    with np.load(d / "jax.npz") as f:
        jx = dict(f)
    ranks = []
    for p in paths:
        with np.load(p) as f:
            ranks.append(dict(f))
    return inp, jx, ranks


def _rank_of(name, w, model=0):
    """The rank of worker ``w`` (model shard ``model``) on a mesh."""
    return w * 2 + model if name == "dm" else w


def _assemble(ranks, name, key, leaf):
    """The aggregate of ``leaf`` from worker 0's ranks: on dm its model
    shards concatenated (leaf "a" is split along dim 1)."""
    if name == "dm" and R.specs_for(name)[leaf] is not None:
        return np.concatenate([ranks[_rank_of(name, 0, j)][f"{key}/{leaf}"]
                               for j in range(2)], axis=1)
    return ranks[0][f"{key}/{leaf}"]


def _local_reference(inp, name, rule, elastic):
    """The port's aggregate_local on the workers' stacked full rows."""
    m = R.MESHES[name][2]
    G = torch.from_numpy(np.concatenate(
        [inp[f"{name}/G/{k}"].reshape(m, -1) for k in sorted(R.LEAVES)], 1))
    valid = torch.from_numpy(np.float32(R.VALID[name])) if elastic else None
    agg, st = engine.aggregate_local(G, ByzantineConfig(aggregator=rule),
                                     return_state=True, valid=valid)
    out, a = {}, 0
    for k in sorted(R.LEAVES):
        n = math.prod(R.LEAVES[k])
        out[k] = agg[a:a + n].reshape(R.LEAVES[k]).numpy()
        a += n
    return out, st


ENGINE_CASES = [(n, lay, el, r) for n in R.MESHES for lay in R.LAYOUTS
                for el in (False, True) for r in engine.registered()]


def _case_id(c):
    return f"{c[0]}-{c[1]}-{'elastic' if c[2] else 'fixed'}-{c[3]}"


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert np.isfinite(got).all() == np.isfinite(want).all(), what
    assert err <= AGG_TOL * scale, (what, err, scale)


@pytest.mark.parametrize("case", ENGINE_CASES, ids=_case_id)
def test_aggregate_sharded_matches_jax(case, runs):
    inp, jx, ranks = runs
    name, layout, elastic, rule = case
    key = f"{name}/{layout}/{int(elastic)}/{rule}"
    for k in R.LEAVES:
        _close(_assemble(ranks, name, f"{key}/agg", k),
               jx[f"{key}/agg/{k}"], (key, k))
    for sk in R.state_keys(rule, elastic):
        want = jx[f"{key}/st/{sk}"]
        for rk in ranks:            # replicated: the same on every rank
            got = rk[f"{key}/st/{sk}"]
            if sk in ("selected", "scores"):
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                np.testing.assert_allclose(got, want, rtol=AGG_TOL,
                                           err_msg=key)


@pytest.mark.parametrize("case", ENGINE_CASES, ids=_case_id)
def test_aggregate_sharded_matches_aggregate_local(case, runs):
    inp, _jx, ranks = runs
    name, layout, elastic, rule = case
    key = f"{name}/{layout}/{int(elastic)}/{rule}"
    want, st = _local_reference(inp, name, rule, elastic)
    for k in R.LEAVES:
        _close(_assemble(ranks, name, f"{key}/agg", k), want[k], (key, k))
    for sk in R.state_keys(rule, elastic):
        got = ranks[0][f"{key}/st/{sk}"]
        ref = getattr(st, sk).numpy()
        if sk in ("selected", "scores"):
            np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            np.testing.assert_allclose(got, ref, rtol=AGG_TOL, err_msg=key)


@pytest.mark.parametrize("case", ENGINE_CASES, ids=_case_id)
def test_collective_counts_equal_expected(case, runs):
    _inp, jx, ranks = runs
    name, layout, elastic, rule = case
    key = f"{name}/{layout}/{int(elastic)}/{rule}"
    spec = engine.get_spec(rule)
    # the elastic round takes no fast path, as in the reference
    want = (engine.expected_collectives(spec, "auto", 3, plan=R.PLAN,
                                        fast_paths=not elastic)
            if layout == "mixed" else
            engine.expected_collectives(spec, layout, 3,
                                        fast_paths=not elastic))
    for rk in ranks:
        np.testing.assert_array_equal(
            rk[f"{key}/collectives"],
            [want["all_gather"], want["all_to_all"]], err_msg=key)
        assert list(rk[f"{key}/device_types"]) in ([], ["cpu"])


@pytest.mark.parametrize("rule", engine.registered())
def test_expected_collectives_equal_the_reference(rule, runs):
    _inp, jx, _ranks = runs
    spec = engine.get_spec(rule)
    for layout in ("local", "gather", "a2a"):
        for n in (1, 3, 7):
            c = engine.expected_collectives(spec, layout, n)
            np.testing.assert_array_equal(
                [c["all_gather"], c["all_to_all"]],
                jx[f"expected/{rule}/{layout}/{n}"])
    c = engine.expected_collectives(spec, "auto", 3, plan=R.PLAN)
    np.testing.assert_array_equal([c["all_gather"], c["all_to_all"]],
                                  jx[f"expected/{rule}/auto/3"])
    with pytest.raises(ValueError):
        engine.expected_collectives(spec, "ring", 3)


@pytest.mark.parametrize("name", list(R.MESHES))
@pytest.mark.parametrize("layout", ["gather", "a2a"])
def test_robust_aggregate_matches_jax(name, layout, runs):
    _inp, jx, ranks = runs
    key = f"{name}/{layout}/0/brsgd"
    for k in R.LEAVES:
        _close(_assemble(ranks, name, f"{key}/agg", k),
               jx[f"{name}/robust/{layout}/{k}"], (name, layout, k))


INJECT_CASES = [(n, el, a) for n in R.MESHES for el in (False, True)
                for a in R.DETERMINISTIC_ATTACKS]


def _alie_slack(inp, name, elastic, leaf):
    """ALIE's per-coordinate float32 uncertainty: its variance is
    hsqsum/n - mu², which cancels where the honest values lie close; a
    few float32 ulps of hsqsum/n (the two packages round the moments in
    other orders, and XLA may fuse the product into the subtraction)
    move sqrt(var) by up to z·(sqrt(var + δ) - sqrt(var - δ)), with δ =
    8·eps·(hsqsum/n + mu²), from the float64 moments of the honest rows."""
    m = R.MESHES[name][2]
    act = (np.float32(R.INJECT_VALID[name]) if elastic
           else np.ones(m, np.float32)) > 0
    nb = int(R.INJECT_ALPHA * act.sum())
    byz = act & (np.cumsum(act) <= nb)
    honest = inp[f"{name}/G/{leaf}"][act & ~byz].astype(np.float64)
    n = honest.shape[0]
    mu = honest.sum(0) / n
    sq = (honest ** 2).sum(0) / n
    var = np.maximum(sq - mu * mu, 0.0)
    delta = 8 * np.finfo(np.float32).eps * (sq + mu * mu)
    z = ByzantineConfig().alie_z
    return z * (np.sqrt(var + delta) - np.sqrt(np.maximum(var - delta, 0)))


@pytest.mark.parametrize("case", INJECT_CASES,
                         ids=lambda c: f"{c[0]}-{int(c[1])}-{c[2]}")
def test_inject_matches_jax(case, runs):
    inp, jx, ranks = runs
    name, elastic, attack = case
    key = f"{name}/inject/{int(elastic)}/{attack}"
    m = R.MESHES[name][2]
    for w in range(m):
        for k in R.LEAVES:
            got = (np.concatenate([ranks[_rank_of(name, w, j)][f"{key}/{k}"]
                                   for j in range(2)], axis=1)
                   if name == "dm" and R.specs_for(name)[k] is not None
                   else ranks[_rank_of(name, w)][f"{key}/{k}"])
            want = jx[f"{key}/{k}"][w]
            scale = max(float(np.abs(want).max()), 1e-30)
            tol = AGG_TOL * scale
            if attack == "alie":
                tol = tol + _alie_slack(inp, name, elastic, k)
            assert (np.abs(got - want) <= tol).all(), \
                (key, w, k, float(np.abs(got - want).max()))
    cfg = ByzantineConfig(attack=attack, alpha=R.INJECT_ALPHA)
    want_ar = threat.inject_collectives(cfg, len(R.LEAVES), m)["all_reduce"]
    for r, rk in enumerate(ranks):
        assert int(rk[f"{key}/all_reduce"]) == want_ar, (key, r)


def test_inject_collectives_equal_the_reference(runs):
    _inp, jx, _ranks = runs
    for attack in R.DETERMINISTIC_ATTACKS + ("gaussian", "label_flip"):
        for n in (1, 3):
            c = threat.inject_collectives(
                ByzantineConfig(attack=attack, alpha=R.INJECT_ALPHA), n, 4)
            np.testing.assert_array_equal(
                [c["all_reduce"], c["axis_index"]],
                jx[f"inject_expected/{attack}/{n}"])


@pytest.mark.parametrize("elastic", [False, True])
def test_gaussian_noise_is_the_same_on_every_mesh(elastic, runs):
    """Worker 0 is byzantine on both meshes (prefix membership); its
    noise for a leaf comes from (seed, worker, leaf) and is drawn for
    the whole leaf, so flat's and dm's (whose leaf "a" is split over
    'model') are the same bits; honest workers keep their gradient, and
    the noise is N(0, 200^2)."""
    inp, _jx, ranks = runs
    key = f"inject/{int(elastic)}/gaussian"
    noise = []
    for k in R.LEAVES:
        flat = ranks[0][f"flat/{key}/{k}"]
        dm = (np.concatenate([ranks[j][f"dm/{key}/{k}"] for j in range(2)],
                             axis=1) if k == "a" else ranks[0][f"dm/{key}/{k}"])
        np.testing.assert_array_equal(flat, dm)
        noise.append(flat.ravel())
        # worker 3 of flat is honest (and active in the elastic round)
        np.testing.assert_array_equal(ranks[3][f"flat/{key}/{k}"],
                                      inp[f"flat/G/{k}"][3])
    z = np.concatenate(noise) / 200.0
    assert abs(z.mean()) < 0.35 and 0.75 < z.std() < 1.25, (z.mean(), z.std())


TRAIN_CASES = list(R.train_cases())


def _params_err(got, want, before):
    dp = max(float(np.abs(w - b).max()) for w, b in zip(want, before))
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    return err, dp


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_step_on_ranks_matches_jax(case, runs):
    inp, jx, ranks = runs
    name, layout, guard = R.train_cases()[case]
    defs = TF.param_defs(R.train_config(name, layout, guard).model)
    paths = R.tree_paths(defs)
    before = [inp["params" + p] for p in paths]
    for s in range(R.STEPS):
        key = f"train/{case}/{s}"
        got = [ranks[0][f"{key}/params{p}"] for p in paths]
        want = [jx[f"{key}/params{p}"] for p in paths]
        for k in ("n_selected", "n_selected_min", "n_active", "step_ok",
                  "grad_finite", "loss_spike"):
            if f"{key}/met/{k}" in jx:
                assert float(ranks[0][f"{key}/met/{k}"]) == float(
                    jx[f"{key}/met/{k}"]), (key, k)
        for k in ("loss", "ce", "gnorm"):
            w, g = float(jx[f"{key}/met/{k}"]), float(
                ranks[0][f"{key}/met/{k}"])
            if not np.isfinite(w):
                assert not np.isfinite(g), (key, k, g)
                continue
            assert abs(g - w) <= REL_TOL * abs(w), (key, k, g, w)
        if guard and not float(jx[f"{key}/met/step_ok"]):
            for g, b in zip(got, before):
                assert np.array_equal(g, b), key        # held
            continue
        err, dp = _params_err(got, want, before)
        assert dp > 0 and err <= PARAM_TOL * dp, (key, err, dp)
        # every rank holds the same params (rank 0 wrote them) and the
        # same metrics
        for rk in ranks[1:]:
            assert float(rk[f"{key}/met/loss"]) == float(
                ranks[0][f"{key}/met/loss"])
        before = got


@pytest.mark.parametrize("case", ["flat_gather", "flat_a2a", "dm_gather",
                                  "dm_a2a"])
def test_train_step_on_ranks_matches_the_single_device_step(case, runs):
    """The same step with the mesh's m workers simulated on one device
    (the local executor on G [m, D])."""
    inp, _jx, ranks = runs
    name, layout, guard = R.train_cases()[case]
    tcfg = R.train_config(name, "gather", guard)
    m = R.MESHES[name][2]
    bundle = build_train_step(tcfg, m, "cpu")
    defs = TF.param_defs(tcfg.model)
    paths = R.tree_paths(defs)
    params = R.params_from(inp, "params", defs, "cpu")
    opt = bundle.opt_init(params)
    before = [inp["params" + p] for p in paths]
    for s in range(R.STEPS):
        params, opt, met = bundle.step_fn(
            params, opt, {"tokens": inp[f"{name}/tok/{s}"]}, s, None)
        key = f"train/{case}/{s}"
        want = [x.numpy() for x in PM.tree_leaves(params)]
        got = [ranks[0][f"{key}/params{p}"] for p in paths]
        assert met["n_selected"] == float(ranks[0][f"{key}/met/n_selected"])
        err, dp = _params_err(got, want, before)
        assert dp > 0 and err <= PARAM_TOL * dp, (key, err, dp)
        before = want
        params = R.params_from({"p" + p: g for p, g in zip(paths, got)},
                               "p", defs, "cpu")


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_step_collectives_equal_expected(case, runs):
    _inp, _jx, ranks = runs
    name, layout, guard = R.train_cases()[case]
    n_leaves = len(PM.tree_leaves(TF.param_defs(
        R.train_config(name, layout, guard).model)))
    want = engine.expected_collectives(engine.get_spec("brsgd"), layout,
                                       n_leaves)
    for s in range(R.STEPS):
        for rk in ranks:
            np.testing.assert_array_equal(
                rk[f"train/{case}/{s}/collectives"],
                [want["all_gather"], want["all_to_all"]])


def _rank_checks(rank):
    """On 2 CPU ranks: the errors ("auto" with no plan, a plan of the
    wrong length, an unknown layout, a step with "auto" and no plan),
    then the reduced qwen3's step under an explicit per-leaf plan
    against the same step under "gather" from the same params: (error
    messages, max|Δ params| over max|Δp|, the plan step's collectives,
    the leaf count)."""
    from repro_torch.configs import TrainConfig, get_config
    mesh = MM.make_mesh((2,), ("data",), device="cpu")
    g = {"a": torch.ones(3), "b": torch.ones(2)}
    cfg = ByzantineConfig(aggregator="brsgd")
    msgs = []
    for kw in ({"layout": "auto"}, {"layout": "auto", "plan": ("a2a",)},
               {"layout": "ring"}):
        try:
            engine.aggregate_sharded(g, cfg, mesh, ("data",), **kw)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    model = get_config("qwen3-0.6b").reduced()
    try:
        build_train_step(TrainConfig(model=model, agg_layout="auto"),
                         mesh=mesh)
        msgs.append(None)
    except ValueError as e:
        msgs.append(str(e))
    defs = TF.param_defs(model)
    n = len(PM.tree_leaves(defs))
    plan = tuple("a2a" if i % 2 else "gather" for i in range(n))
    tokens = np.random.default_rng(1).integers(0, model.vocab, (2, 1, 16))
    after = []
    for layout, kw in (("gather", {}), ("auto", {"plan": plan})):
        tcfg = TrainConfig(model=model, byzantine=ByzantineConfig(
            attack="sign_flip", alpha=0.5), optimizer="sgd", lr=1.0,
            agg_layout=layout)
        bundle = build_train_step(tcfg, mesh=mesh, **kw)
        params = PM.init_params(defs, torch.Generator().manual_seed(5))
        with R.aggregation_counts() as seen:
            bundle.step_fn(params, bundle.opt_init(params),
                           {"tokens": tokens}, 0, None)
        after.append([x.numpy().copy() for x in PM.tree_leaves(params)])
    init = [x.numpy() for x in PM.tree_leaves(
        PM.init_params(defs, torch.Generator().manual_seed(5)))]
    dp = max(float(np.abs(a - b).max()) for a, b in zip(after[0], init))
    err = max(float(np.abs(a - b).max()) for a, b in zip(*after))
    return msgs, err / dp, seen[-1], n, plan


def test_plans_and_errors_on_ranks():
    """A step under an explicit plan equals the gather step (within 1e-5
    of max|Δp|) and issues the plan's expected collectives; "auto"
    without a plan raises, naming ROADMAP A.6."""
    for msgs, rel, seen, n, plan in MM.launch(_rank_checks, 2, (),
                                              device="cpu", threads=1,
                                              verbose=False):
        assert msgs[0] is not None and "A.6" in msgs[0]
        assert msgs[1] is not None and "covers 1 leaves" in msgs[1]
        assert msgs[2] is not None and "unknown layout" in msgs[2]
        assert msgs[3] is not None and "A.6" in msgs[3]
        assert rel <= PARAM_TOL, rel
        want = engine.expected_collectives(engine.get_spec("brsgd"), "auto",
                                           n, plan=plan)
        assert seen == {k: want[k] for k in seen}


def test_mesh_with_workers_is_an_error(capsys):
    with pytest.raises(SystemExit):
        train_main(["--reduced", "--device", "cpu", "--mesh", "4",
                    "--workers", "4", "--steps", "1"])
    assert "--mesh" in capsys.readouterr().err


def test_nccl_with_two_ranks_on_one_device_raises():
    with pytest.raises(ValueError, match="nccl refuses"):
        MM.check_backend("nccl", 4, "cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        MM.check_backend("mpi", 4, "cpu")


def test_pspec_tree_matches_the_reference_rules():
    """The port's specs of the reduced qwen3 on a 2 x 2 mesh: 'model' on
    the first tensor-parallel dimension that divides (vocab, heads, kv,
    ff), None elsewhere; fsdp=True waits for A.4."""
    class FakeMesh:
        axis_names, shape = ("data", "model"), (2, 2)
    defs = TF.param_defs(R.train_config("dm", "gather", False).model)
    specs = PM.pspec_tree(defs, FakeMesh())
    assert specs["embed"] == ("model", None)
    assert specs["final_norm"] == (None,)
    assert specs["seg_0"]["attn"]["wq"] == (None, None, "model", None)
    assert specs["seg_0"]["mlp"]["w_out"] == (None, "model", None)
    with pytest.raises(NotImplementedError, match="A.4"):
        PM.pspec_tree(defs, FakeMesh(), fsdp=True)


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1"):
        MM.launch(_fail_on_rank_one, 2, (), device="cpu", threads=1,
                  verbose=False, timeout_s=120)


def _fail_on_rank_one(rank):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def test_launcher_runs_the_mesh_step(tmp_path, capsys):
    """``launch.train --mesh 2 --device cpu``: two ranks train the
    reduced qwen3 for 2 steps under the a2a layout."""
    hist = train_main(["--reduced", "--device", "cpu", "--mesh", "2",
                       "--steps", "2", "--seq", "16", "--batch-per-worker",
                       "1", "--optimizer", "sgd", "--agg-layout", "a2a",
                       "--attack", "sign_flip", "--alpha", "0.5"])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["n_selected"] == 1.0
               for h in hist)
    assert "backend=gloo ranks=2" in capsys.readouterr().out
