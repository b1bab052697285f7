"""The port's blocked scope (``repro_torch.core.blocked``, the blocked
train step of ``training/step.py``) against the JAX package's blocked
step and its ``core.blocked._bucket_aggregate``, on the CPU.

Every JAX case runs in one 8-device subprocess on the flat ("data",)
mesh, results read from an npz; both packages start from the same
parameters (the JAX init carried across) and the same
``LMWorkerPipeline`` batches.

Step cases: reduced qwen3 with brsgd under sign_flip (alpha 0.25) and
sgd at lr 1, 2 steps; reduced rwkv6, brsgd, 1 step; reduced zamba2 (the
hybrid segment: a bucket a unit, ``shared_attn`` in the top bucket),
brsgd under alie, 1 step; elastic rounds at quorum 6 of 8 under median
and krum; a guarded step with a NaN on worker 5 (held), then worker 5
evicted.  Checks: ``n_selected`` / ``n_selected_min`` exact (the
selection-token histogram of the reference: the mean over the bucket
calls and the smallest count), ``loss`` / ``ce`` / ``gnorm`` within
1e-5 relative (NaN where the reference's is), the guard's flags equal,
sgd params within 1e-5 of the step's largest |Δp| and a held step's
params the input's bits: the tolerances of test_torch_train_step.py.
The selection is per bucket in both packages (a deviation from the
paper, DESIGN.md §2), so the blocked step is held to the JAX blocked
step, never to the port's global step.

Score counts past 2^24 columns (ROADMAP §C.3): qwen3-0.6b's top bucket
has 155,583,488 columns and rwkv6-7b's 536,875,008; the reference sums
its score partials in float32 and rounds past 2^24, the port counts
exactly (a kept divergence).  Parity is held here at the reduced sizes,
where no partial reaches 2^24.

Bucket cases: the port's ``_bucket_aggregate`` against the reference's
under shard_map on the same [8, ...] bucket arrays (an FSDP-sharded
leaf, a replicated leaf of 7 columns, a non-divisible one), for every
registered rule, fixed and elastic: selections exact, aggregates within
1e-5 of their largest magnitude (geomedian included: the reference's
Weiszfeld loop runs in Gram space, the port's on the rows).

Port-only checks: the layer-major backward's lockstep (at most the top
bucket and one layer bucket live, with and without remat, for the
dense, rwkv, moe and hybrid segments), one bucket aggregation per layer
(per unit) plus the top, no tensor of the step as large as [m, D], one
membership for every bucket under ``resample`` and gaussian noise that
differs across buckets and across the layers of one segment.
"""
import textwrap

import numpy as np
import pytest
import torch

from conftest import run_multidevice
from repro_torch.configs import (ByzantineConfig, RecoveryConfig,
                                 TrainConfig, get_config)
from repro_torch.core import blocked, engine, threat
from repro_torch.data.pipeline import LMWorkerPipeline
from repro_torch.models import params as PM
from repro_torch.models import transformer as TF
from repro_torch.training import build_train_step, step_generator

M, B, S = 8, 2, 32
SF = {"attack": "sign_flip", "alpha": 0.25}
ACT = [1, 1, 0, 1, 1, 1, 0, 1]          # the elastic rounds: 6 of 8 arrive
FAULT = [0, 0, 0, 0, 0, 1, 0, 0]        # the guarded step: worker 5 NaN
EVICTED = [1, 1, 1, 1, 1, 0, 1, 1]      # ... then evicted
# name: (arch, ByzantineConfig kwargs, steps, active per step, faults per
#        step, guard, grad_clip); every case sgd at lr 1
CASES = {
    "qwen_sgd": ("qwen3-0.6b", SF, 2, None, None, False, 0.0),
    "rwkv_sgd": ("rwkv6-7b", SF, 1, None, None, False, 0.0),
    "zamba_alie": ("zamba2-2.7b", {"attack": "alie", "alpha": 0.25}, 1,
                   None, None, False, 0.0),
    "elastic_median": ("qwen3-0.6b", {**SF, "aggregator": "median",
                                      "max_m": M, "quorum": 6},
                       1, [ACT], None, False, 0.0),
    "elastic_krum": ("qwen3-0.6b", {**SF, "aggregator": "krum", "max_m": M,
                                    "quorum": 6}, 1, [ACT], None, False, 0.0),
    "guard": ("qwen3-0.6b", {**SF, "max_m": M, "quorum": 6}, 2,
              [[1] * M, EVICTED], [FAULT, FAULT], True, 0.0),
}
# ROADMAP §C.6: the reference's blocked step clips inside its shard_map,
# each FSDP shard by its own norm; held apart from CASES
CLIP_CASE = ("qwen3-0.6b", SF, 1, None, None, False, 1.0)
RULES = ("brsgd", "geomedian", "krum", "mean", "median", "multi_krum",
         "trimmed_mean")
REL_TOL = 1e-5
PARAM_TOL = 1e-5
AGG_TOL = 1e-5

_SNIPPET = textwrap.dedent("""
    import jax, jax.numpy as jnp, numpy as np
    from functools import partial
    from repro.compat import shard_map, P
    from repro.configs import get_config, TrainConfig, ByzantineConfig
    from repro.configs import RecoveryConfig
    from repro.core import engine
    from repro.core.blocked import _bucket_aggregate
    from repro.data.pipeline import LMWorkerPipeline
    from repro.launch.mesh import make_mesh
    from repro.models import params as PM, transformer as TF
    from repro.training.step import build_train_step

    M, B, S = %(M)d, %(B)d, %(S)d
    CASES = %(CASES)r
    mesh = make_mesh((M,), ("data",))
    out = {}

    def flat(tree, prefix):
        if isinstance(tree, dict):
            r = {}
            for k in sorted(tree):
                r.update(flat(tree[k], prefix + "/" + k))
            return r
        return {prefix: np.asarray(tree)}

    for name, (arch, bkw, steps, actives, faults, guard,
               clip) in CASES.items():
        cfg = get_config(arch).reduced()
        bcfg = ByzantineConfig(**bkw)
        tcfg = TrainConfig(model=cfg, byzantine=bcfg, optimizer="sgd",
                           lr=1.0, grad_clip=clip, agg_scope="blocked",
                           agg_layout="a2a",
                           recovery=RecoveryConfig(guard=guard))
        bundle = build_train_step(tcfg, mesh)
        psh, osh, bsh = bundle.shardings(mesh)
        # one jitted program, not an eager op a leaf
        params = jax.jit(lambda k, d=TF.param_defs(cfg): PM.init_params(
            d, k))(jax.random.PRNGKey(0))
        params = jax.tree.map(np.asarray, params)
        pipe = LMWorkerPipeline(cfg, M, B, S, seed=1, byz=bcfg)
        out.update(flat(params, name + "/init"))
        key = jax.random.PRNGKey(0)
        for s in range(steps):
            tokens = pipe.batch(s)["tokens"]
            out[f"{name}/{s}/tokens"] = tokens
            args = [jax.device_put(params, psh), (),
                    {"tokens": jax.device_put(jnp.asarray(tokens),
                                              bsh["tokens"])},
                    jnp.int32(s), jax.random.fold_in(key, s)]
            if bcfg.elastic:
                args.append(jnp.float32(actives[s]))
            if guard:
                args += [jnp.float32(faults[s]), jnp.float32(-1.0)]
            with mesh:
                params, _, met = bundle.step_fn(*args)
            params = jax.tree.map(np.asarray, params)
            out.update({f"{name}/{s}/met/{k}": np.asarray(v)
                        for k, v in met.items()})
            out.update(flat(params, f"{name}/{s}/params"))

    # the bucket cases: the reference's _bucket_aggregate under shard_map
    axes = ("data",)
    specs = {"w": P("data", None), "b": P(None), "u": P("data")}
    SHARDED = {"w": 0}
    rng = np.random.default_rng(3)
    full = {"w": rng.normal(size=(M, 2 * M, 6)),
            "b": rng.normal(size=(M, 7)),
            "u": rng.normal(size=(M, M - 2))}
    scale = np.ones((M, 1, 1))
    scale[: M // 4] = -4.0
    full = {k: (0.3 * v + rng.normal(size=v.shape[1:])
                ) * scale.reshape((M,) + (1,) * (v.ndim - 1))
            for k, v in full.items()}
    full = {k: v.astype("f4") for k, v in full.items()}
    out.update({f"bucket/in/{k}": v for k, v in full.items()})

    # every rule, fixed and elastic, in one shard_map: one compile
    cases = [(rule, mode) for rule in %(RULES)r
             for mode in ("fixed", "elastic")]

    @partial(shard_map, mesh=mesh,
             in_specs=({k: P("data") for k in full}, P()),
             out_specs=P())
    def run_all(t, vf):
        local = {k: v.reshape(v.shape[1:]) for k, v in t.items()}
        res = {}
        for rule, mode in cases:
            kw = {"max_m": M, "quorum": 6} if mode == "elastic" else {}
            cfg = ByzantineConfig(aggregator=rule, alpha=0.25, **kw)
            o, st = _bucket_aggregate(local, specs, cfg, axes,
                                      valid=vf if mode == "elastic" else None)
            for k, v in o.items():
                res[f"{rule}/{mode}/agg/{k}"] = (
                    jax.lax.all_gather(v, axes, axis=SHARDED[k], tiled=True)
                    if k in SHARDED else v)
            res[f"{rule}/{mode}/selected"] = st.selected.astype(jnp.float32)
        return res
    res = jax.jit(run_all)({k: jnp.asarray(v) for k, v in full.items()},
                           jnp.float32(%(ACT)r))
    out.update({"bucket/" + k: np.asarray(v) for k, v in res.items()})
    np.savez(%(OUT)r, **out)
    print("OK")
""")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small CPU work: one torch thread per test worker process, the
    module's fixtures included."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf_paths(defs, path=""):
    if isinstance(defs, dict):
        return [p for k in sorted(defs) for p in _leaf_paths(defs[k],
                                                             f"{path}/{k}")]
    return [path]


def _tree_from(ref_npz, prefix, defs, path=""):
    if isinstance(defs, dict):
        return {k: _tree_from(ref_npz, prefix, defs[k], f"{path}/{k}")
                for k in sorted(defs)}
    return torch.from_numpy(ref_npz[prefix + path].copy())


def _tcfg(arch, bkw, guard=False, remat="none", clip=0.0):
    return TrainConfig(model=get_config(arch).reduced(),
                       byzantine=ByzantineConfig(**bkw), optimizer="sgd",
                       lr=1.0, grad_clip=clip, agg_scope="blocked",
                       agg_layout="a2a", remat=remat,
                       recovery=RecoveryConfig(guard=guard))


@pytest.fixture(scope="module")
def jax_blocked(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_blocked") / "blocked.npz")
    code = _SNIPPET % {"M": M, "B": B, "S": S,
                       "CASES": {**CASES, "qwen_clip": CLIP_CASE},
                       "RULES": RULES, "ACT": ACT, "OUT": path}
    assert "OK" in run_multidevice(code, n_devices=M, timeout=560)
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def port_steps(jax_blocked):
    """Every step case through the port's blocked step on the CPU from
    the JAX case's initial params and batches."""
    out = {}
    for name, (arch, bkw, steps, actives, faults, guard,
               clip) in CASES.items():
        tcfg = _tcfg(arch, bkw, guard, clip=clip)
        bundle = build_train_step(tcfg, M, "cpu")
        assert (bundle.scope, bundle.layout) == ("blocked", "a2a")
        defs = TF.param_defs(tcfg.model)
        params = _tree_from(jax_blocked, f"{name}/init", defs)
        rows = []
        for s in range(steps):
            tokens = jax_blocked[f"{name}/{s}/tokens"]
            before = [p.clone() for p in PM.tree_leaves(params)]
            args = [params, (), {"tokens": tokens}, s, None]
            if tcfg.byzantine.elastic:
                args.append(np.float32(actives[s]))
            if guard:
                args += [np.float32(faults[s]), -1.0]
            params, _, met = bundle.step_fn(*args)
            rows.append({"before": before, "met": met,
                         "after": [p.clone() for p in PM.tree_leaves(params)],
                         "paths": _leaf_paths(defs)})
        out[name] = rows
    return out


def _steps(name):
    return range(CASES[name][2])


@pytest.mark.parametrize("name", CASES)
def test_blocked_selection_matches_jax(name, jax_blocked, port_steps):
    for s in _steps(name):
        met = port_steps[name][s]["met"]
        for k in ("n_selected", "n_selected_min"):
            assert met[k] == float(jax_blocked[f"{name}/{s}/met/{k}"]), \
                (s, k, met[k])
        assert met["n_selected_min"] <= met["n_selected"]


@pytest.mark.parametrize("name", CASES)
def test_blocked_metrics_match_jax(name, jax_blocked, port_steps):
    for s in _steps(name):
        met = port_steps[name][s]["met"]
        want = {k[len(f"{name}/{s}/met/"):]: v for k, v in
                jax_blocked.items() if k.startswith(f"{name}/{s}/met/")}
        assert sorted(met) == sorted(want)
        for k in ("loss", "ce", "gnorm"):
            w = float(want[k])
            if not np.isfinite(w):
                assert not np.isfinite(met[k]), (s, k, met[k])
                continue
            assert abs(met[k] - w) <= REL_TOL * abs(w), (s, k, met[k], w)
        for k in ("n_active", "step_ok", "grad_finite", "loss_spike"):
            if k in want:
                assert met[k] == float(want[k]), (s, k)
        if "worker_ok" in want:
            np.testing.assert_array_equal(met["worker_ok"], want["worker_ok"])


@pytest.mark.parametrize("name", CASES)
def test_blocked_params_match_jax(name, jax_blocked, port_steps):
    guard = CASES[name][5]
    for s in _steps(name):
        row = port_steps[name][s]
        want = [jax_blocked[f"{name}/{s}/params{p}"] for p in row["paths"]]
        got = [t.numpy() for t in row["after"]]
        before = [t.numpy() for t in row["before"]]
        if guard and not row["met"]["step_ok"]:
            for g, b in zip(got, before):
                assert np.array_equal(g, b)        # held: the input's bits
            for w, b in zip(want, before):
                assert np.array_equal(w, b)
            continue
        dp = max(float(np.abs(w - b).max()) for w, b in zip(want, before))
        assert dp > 0
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        print(name, s, "max |dp|", dp, "max err", err)
        assert err <= PARAM_TOL * dp, (s, err, dp)


def _bucket_in(jax_blocked):
    return {k: torch.from_numpy(jax_blocked[f"bucket/in/{k}"])
            for k in ("b", "u", "w")}


@pytest.mark.parametrize("mode", ["fixed", "elastic"])
@pytest.mark.parametrize("rule", RULES)
def test_bucket_aggregate_matches_jax(rule, mode, jax_blocked):
    """The port's ``_bucket_aggregate`` on the reference's [8, ...] bucket
    arrays: the selection exact, each leaf's aggregate within AGG_TOL of
    its largest magnitude."""
    elastic = mode == "elastic"
    kw = {"max_m": M, "quorum": 6} if elastic else {}
    bcfg = ByzantineConfig(aggregator=rule, alpha=0.25, **kw)
    valid = torch.tensor(ACT, dtype=torch.float32) if elastic else None
    got, st = blocked._bucket_aggregate(_bucket_in(jax_blocked), bcfg,
                                        valid)
    pre = f"bucket/{rule}/{mode}"
    np.testing.assert_array_equal(st.selected.numpy().astype(np.float32),
                                  jax_blocked[f"{pre}/selected"])
    for k in ("b", "u", "w"):
        want = jax_blocked[f"{pre}/agg/{k}"]
        g = got[k].numpy()
        assert g.shape == want.shape
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g, want, rtol=0, atol=AGG_TOL * scale,
                                   err_msg=f"{rule} {mode} {k}")


def test_column_rules_per_bucket_equal_the_global_column_pass():
    """A column rule works per column, so a bucket's aggregate is the
    global scope's column pass on the same rows, bit for bit."""
    rng = np.random.default_rng(5)
    G = torch.from_numpy(rng.normal(size=(M, 300)).astype(np.float32))
    tree = {"a": G[:, :120].reshape(M, 10, 12), "b": G[:, 120:]}
    for rule in ("median", "trimmed_mean", "mean"):
        bcfg = ByzantineConfig(aggregator=rule, alpha=0.25)
        got, _ = blocked._bucket_aggregate(tree, bcfg)
        want = engine.aggregate_local(G, bcfg)
        assert torch.equal(torch.cat([got["a"].reshape(-1), got["b"]]),
                           want), rule


# ---------------------------------------------------------------------------
# port-only checks
# ---------------------------------------------------------------------------

class _Recording(blocked.BlockedRound):
    """BlockedRound that keeps every round of the step it serves."""
    rounds: list = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _Recording.rounds.append(self)


@pytest.fixture
def recording(monkeypatch):
    _Recording.rounds = []
    monkeypatch.setattr(blocked, "BlockedRound", _Recording)
    return _Recording.rounds


def _one_step(arch, bkw, remat="none", m=4, steps=1):
    tcfg = _tcfg(arch, bkw, remat=remat)
    bundle = build_train_step(tcfg, m, "cpu")
    params = PM.init_params(TF.param_defs(tcfg.model),
                            torch.Generator().manual_seed(0))
    pipe = LMWorkerPipeline(tcfg.model, m, 2, 16, seed=1,
                            byz=tcfg.byzantine)
    for s in range(steps):
        params, _, met = bundle.step_fn(params, (), pipe.batch(s), s, None)
    return tcfg, params, met


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b", "dbrx-132b",
                                  "zamba2-2.7b"])
def test_backward_runs_the_buckets_in_lockstep(arch, remat, recording):
    """At most two buckets' rows live at once, the top one and one layer
    (unit) bucket; the layer buckets finish top layer first, the top
    bucket last (the embedding lookup's gradient comes last); one
    aggregation a layer (a unit for hybrid) plus the top."""
    tcfg, _, met = _one_step(arch, SF, remat)
    (rnd,) = recording
    assert rnd.live == set()
    assert len(rnd.peak_live) == 2 and ("top", 0) in rnd.peak_live
    want = [(f"seg_{i}", l) for i, seg in reversed(
        list(enumerate(TF.segments(tcfg.model))))
        for l in reversed(range(seg.n))] + [("top", 0)]
    assert [(n, l) for n, l, _ in rnd.calls] == want
    counts = [int(c) for _, _, c in rnd.calls]
    assert met["n_selected_min"] == min(counts)
    assert met["n_selected"] == np.float32(sum(counts)) / np.float32(
        len(counts))


class _LargestOutput(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the element count of the largest tensor any op makes."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-2.7b"])
def test_no_m_by_D_tensor_is_made(arch, recording):
    """No op of the blocked step makes a tensor of m·D elements: the
    largest is the rows of the largest bucket, m·d_b."""
    m = 4
    tcfg = _tcfg(arch, SF)
    defs = TF.param_defs(tcfg.model)
    D = PM.count_params(defs)
    d_b = max([PM.count_params(TF._top(defs))] + [
        PM.count_params(defs[f"seg_{i}"]) // seg.n
        for i, seg in enumerate(TF.segments(tcfg.model))])
    bundle = build_train_step(tcfg, m, "cpu")
    params = PM.init_params(defs, torch.Generator().manual_seed(0))
    batch = LMWorkerPipeline(tcfg.model, m, 2, 16, seed=1,
                             byz=tcfg.byzantine).batch(0)
    with _LargestOutput() as mode:
        bundle.step_fn(params, (), batch, 0, None)
    assert mode.largest == m * d_b < m * D, (mode.largest, m * d_b, m * D)


def test_membership_once_a_step_noise_per_bucket_and_layer(recording,
                                                           monkeypatch):
    """Under ``resample`` every bucket corrupts the step's one byzantine
    set; gaussian noise differs across buckets and across the layers of
    one segment, and each bucket's noise has the configured spread."""
    seen = []
    inject = threat.apply_dense_

    def spy(G, gen, cfg, active=None, membership=None):
        out = inject(G, gen, cfg, active, membership)
        seen.append((membership.clone(), G.clone()))
        return out
    monkeypatch.setattr(threat, "apply_dense_", spy)
    m = 8
    bkw = {"attack": "gaussian", "alpha": 0.25, "membership": "resample",
           "aggregator": "mean"}
    tcfg, _, _ = _one_step("qwen3-0.6b", bkw, m=m)
    (rnd,) = recording
    want = threat.membership_mask(tcfg.byzantine, m,
                                  step_generator(tcfg.seed, 0, "cpu"))
    assert int(want.sum()) == 2
    assert len(seen) == 3                       # 2 layers + the top
    for mask, _ in seen:
        assert torch.equal(mask, want)
    byz = torch.nonzero(want).flatten()
    noise = [G[byz] for _, G in seen]           # layer 1, layer 0, top
    n = min(x.shape[1] for x in noise)
    for a in range(3):
        std = float(noise[a].std())
        assert abs(std / tcfg.byzantine.gaussian_std - 1) < 0.05, std
        for b in range(a):
            assert not torch.equal(noise[a][:, :n], noise[b][:, :n])
    # a second step draws its membership anew from its own generator
    masks = {tuple(threat.membership_mask(
        tcfg.byzantine, m, step_generator(tcfg.seed, s, "cpu")).tolist())
        for s in range(8)}
    assert len(masks) > 1


def test_bucket_keys_differ_across_buckets_and_layers():
    keys = {blocked.bucket_key(7, n, l) for n in ("seg_0", "top")
            for l in range(3)}
    assert len(keys) == 6
    assert blocked.bucket_key(7, "seg_0", 1) == blocked.bucket_key(
        7, "seg_0", 1)


def test_layer_major_workers_keep_loss_fn_bits():
    """Without hooks ``loss_fn_workers`` (layer-major) gives every worker
    ``loss_fn``'s loss bit for bit, and identity hooks leave ``loss_fn``
    as it was; the hooks run once a layer and once for the top."""
    for arch in ("qwen3-0.6b", "zamba2-2.7b"):
        cfg = get_config(arch).reduced()
        params = PM.init_params(TF.param_defs(cfg),
                                torch.Generator().manual_seed(1))
        tokens = LMWorkerPipeline(cfg, 3, 2, 16, seed=2).batch(0)["tokens"]
        batches = [{"tokens": torch.from_numpy(t)} for t in tokens]
        losses, mets = TF.loss_fn_workers(cfg, params, batches)
        calls = []

        def hook(p, i):
            calls.append(i)
            return p

        def top(p):
            calls.append("top")
            return p
        for b, loss, met in zip(batches, losses, mets):
            want, wmet = TF.loss_fn(cfg, params, b)
            assert torch.equal(loss, want) and torch.equal(met["ce"],
                                                           wmet["ce"])
            calls.clear()
            got, _ = TF.loss_fn(cfg, params, b, seg_hooks={"seg_0": hook},
                                top_hook=top)
            assert torch.equal(got, want)
            assert calls == ["top"] + list(range(TF.segments(cfg)[0].n))


def test_blocked_step_refuses_what_it_should():
    cfg = get_config("qwen3-0.6b").reduced()
    with pytest.raises(ValueError, match="a2a"):
        build_train_step(TrainConfig(model=cfg, agg_scope="global",
                                     agg_layout="a2a"), 4, "cpu")
    tcfg = _tcfg("qwen3-0.6b", {"max_m": 4, "quorum": 2})
    bundle = build_train_step(tcfg, 4, "cpu")
    params = PM.init_params(TF.param_defs(cfg),
                            torch.Generator().manual_seed(0))
    batch = LMWorkerPipeline(cfg, 4, 2, 16, seed=1).batch(0)
    with pytest.raises(ValueError, match="no active worker"):
        bundle.step_fn(params, (), batch, 0, None, np.zeros(4, np.float32))
    for layout in ("gather", "a2a", "auto"):
        t = TrainConfig(model=cfg, agg_scope="blocked", agg_layout=layout)
        assert build_train_step(t, 4, "cpu").scope == "blocked"


def test_blocked_scope_through_train_main_and_the_supervisor(tmp_path):
    """``launch.train.main`` with ``--agg-scope blocked --remat block``,
    then ``--supervise``: the printed scope and finite metrics, every
    step's ``n_selected_min`` at most its ``n_selected``."""
    from repro_torch.launch import train
    base = ["--reduced", "--device", "cpu", "--workers", "4", "--steps",
            "2", "--batch-per-worker", "1", "--seq", "16", "--attack",
            "sign_flip", "--alpha", "0.25", "--optimizer", "sgd",
            "--agg-scope", "blocked", "--remat", "block"]
    for extra in ([], ["--supervise", "--ckpt-dir", str(tmp_path)]):
        hist = train.main(base + extra)
        assert len(hist) == 2
        for h in hist:
            assert np.isfinite(h["loss"]) and np.isfinite(h["gnorm"])
            assert h["n_selected_min"] <= h["n_selected"] <= 4


def test_reference_clips_each_shard_by_its_own_norm(jax_blocked):
    """ROADMAP §C.6, a kept divergence.  The port clips the blocked
    step's aggregate by its global norm, as its global scope does and as
    the reference's ``gnorm`` metric reads it: with grad_clip 1 every
    leaf's update is the unclipped one times min(1, 1/gnorm).  The
    reference's blocked step runs its optimizer inside the shard_map, so
    each device clips its shards (and its copy of the replicated leaves)
    by the norm of what it holds: every leaf's update is about √8 times
    that factor on 8 devices, while ``gnorm`` is the same in both
    packages."""
    arch, bkw = CLIP_CASE[:2]
    defs = TF.param_defs(get_config(arch).reduced())
    paths = _leaf_paths(defs)
    init = [jax_blocked[f"qwen_sgd/init{p}"] for p in paths]
    assert all(np.array_equal(jax_blocked[f"qwen_clip/init{p}"], a)
               for p, a in zip(paths, init))
    tokens = {"tokens": jax_blocked["qwen_sgd/0/tokens"]}
    upd = {}
    for clip in (0.0, 1.0):
        params = _tree_from(jax_blocked, "qwen_sgd/init", defs)
        bundle = build_train_step(_tcfg(arch, bkw, clip=clip), M, "cpu")
        params, _, met = bundle.step_fn(params, (), tokens, 0, None)
        upd[clip] = [t.numpy() - a for t, a in
                     zip(PM.tree_leaves(params), init)]
    gnorm = float(jax_blocked["qwen_clip/0/met/gnorm"])
    assert abs(met["gnorm"] - gnorm) <= REL_TOL * gnorm and gnorm > 1
    factor = 1.0 / gnorm
    ratio = lambda a, b: float(np.linalg.norm(a) / np.linalg.norm(b))  # noqa
    for p, a, b in zip(paths, upd[1.0], upd[0.0]):
        assert abs(ratio(a, b) / factor - 1) < 1e-4, p
    ref = {p: ratio(jax_blocked[f"qwen_clip/0/params{p}"] - a,
                    jax_blocked[f"qwen_sgd/0/params{p}"] - a)
           for p, a in zip(paths, init)}
    print("reference's clip ratio / 1/gnorm:",
          {p: r / factor for p, r in ref.items()})
    assert all(r > 2 * factor for r in ref.values())
