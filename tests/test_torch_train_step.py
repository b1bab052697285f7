"""The port's BrSGD train step (``repro_torch.training.step``) against the
JAX package's ``build_train_step`` in the global scope with the forced
``"gather"`` layout, on an 8-device host mesh (one subprocess for every
JAX case, its results read from an npz), on the CPU.

Cases: reduced qwen3 with brsgd under sign_flip (alpha 0.25) and sgd, 2
steps; the same with adamw and grad_clip 1.0; reduced rwkv6, brsgd, sgd,
1 step; elastic rounds at quorum 6 of 8 under median and krum; a guarded
step with a NaN fault on worker 5 (held), then worker 5 evicted (ok).
Both packages start from the same parameters and take the same token
batches.

Checks and tolerances:
* the selection of the round: the port's ``aggregate_local`` on the
  port's attacked gradient stack selects the same workers as the
  reference's per-leaf statistics and select rule on its own stack, and
  the step's ``n_selected`` / ``n_selected_min`` equal the reference's.
  Scores and l1 come from per-worker gradients that agree only within
  float32 (the two packages sum in other orders), so the kth-score gap
  and the l1 margin to 2T are printed: a near tie is a finding, not a
  reason to change the seed;
* ``loss`` and ``ce`` within 1e-5 relative, ``gnorm`` within 1e-5
  relative where finite (NaN where the reference's is);
* sgd params within 1e-5 of the step's largest |Δp| (lr 1.0, so that
  |Δp| lies well above a float32 ulp of the params: at lr 1e-2 one ulp
  of a weight near 1 is already 8e-5 of |Δp|); adamw divides by
  sqrt(v), so a coordinate whose aggregate is near 0 turns float32
  differences into O(lr) ones: its params are held, on all but 1% of
  the coordinates, to 1e-5 of |Δp| after the first step (the same
  params on both sides) and to 1e-3 after the second (params that
  differ on those coordinates give both a slightly other gradient: 61%
  of the coordinates lie above 1e-5 there, 0.25% above 1e-3), and finite;
* the guard: ``worker_ok``, ``step_ok``, ``grad_finite``,
  ``loss_spike`` and ``n_active`` equal, the held step's params the
  input's bits.
"""
import textwrap

import numpy as np
import pytest
import torch

from conftest import run_multidevice
from repro_torch.configs import (ByzantineConfig, RecoveryConfig,
                                 TrainConfig, get_config)
from repro_torch.core import engine, threat
from repro_torch.kernels import ref
from repro_torch.models import params as PM
from repro_torch.models import transformer as TF
from repro_torch.training import build_train_step

M, B, S = 8, 2, 32
SF = {"attack": "sign_flip", "alpha": 0.25}
ACT = [1, 1, 0, 1, 1, 1, 0, 1]          # the elastic rounds: 6 of 8 arrive
FAULT = [0, 0, 0, 0, 0, 1, 0, 0]        # the guarded step: worker 5 NaN
EVICTED = [1, 1, 1, 1, 1, 0, 1, 1]      # ... then evicted
# name: (arch, ByzantineConfig kwargs, optimizer, lr, grad_clip, steps,
#        active per step, faults per step, guard)
CASES = {
    "qwen_sgd": ("qwen3-0.6b", SF, "sgd", 1.0, 0.0, 2, None, None, False),
    "qwen_adamw": ("qwen3-0.6b", SF, "adamw", 1e-2, 1.0, 2, None, None,
                   False),
    "rwkv_sgd": ("rwkv6-7b", SF, "sgd", 1.0, 0.0, 1, None, None, False),
    "elastic_median": ("qwen3-0.6b", {**SF, "aggregator": "median",
                                      "max_m": M, "quorum": 6},
                       "sgd", 1.0, 0.0, 1, [ACT], None, False),
    "elastic_krum": ("qwen3-0.6b", {**SF, "aggregator": "krum", "max_m": M,
                                    "quorum": 6},
                     "sgd", 1.0, 0.0, 1, [ACT], None, False),
    "guard": ("qwen3-0.6b", {**SF, "max_m": M, "quorum": 6}, "sgd", 1.0, 0.0,
              2, [[1] * M, EVICTED], [FAULT, FAULT], True),
}
REL_TOL = 1e-5
PARAM_TOL = 1e-5
ADAMW_OUTLIERS = 0.01
ADAMW_LATER_TOL = 1e-3

_SNIPPET = textwrap.dedent("""
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, TrainConfig, ByzantineConfig
    from repro.configs import RecoveryConfig
    from repro.core import engine, threat
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

    def selection(grad_fn, bcfg, params, tokens, active, fault):
        # the reference's round on its attacked gradient stack: per-leaf
        # statistics summed in float32 (aggregate_sharded, gather), then
        # the replicated select rule
        leaves = [x.reshape(M, -1) for x in jax.tree.leaves(
            grad_fn(params, {"tokens": jnp.asarray(tokens)}, fault))]
        vf = None if active is None else jnp.asarray(active, jnp.float32)
        G = threat.apply_dense(jnp.concatenate(leaves, axis=1),
                               jax.random.PRNGKey(0), bcfg, active=vf)
        spec = engine.get_spec(bcfg.aggregator)
        stats, a = engine.zero_stats(spec.stats, M), 0
        for x in leaves:
            part = engine.leaf_stats(G[:, a:a + x.shape[1]], spec.stats, M,
                                     valid=vf)
            stats = {k: stats[k] + part[k] for k in stats}
            a += x.shape[1]
        if vf is not None:
            stats["valid"] = vf
        w, st, _ = engine.resolve_select(spec, stats, bcfg, M)
        return {k: np.asarray(getattr(st, k)) for k in
                ("selected", "scores", "l1", "threshold") if hasattr(st, k)}

    grad_fns = {}
    for name, (arch, bkw, optimizer, lr, clip, steps, actives, faults,
               guard) in CASES.items():
        cfg = get_config(arch).reduced()
        bcfg = ByzantineConfig(**bkw)
        tcfg = TrainConfig(model=cfg, byzantine=bcfg, optimizer=optimizer,
                           lr=lr, grad_clip=clip, agg_scope="global",
                           agg_layout="gather",
                           recovery=RecoveryConfig(guard=guard))
        bundle = build_train_step(tcfg, mesh)
        psh, osh, bsh = bundle.shardings(mesh)
        # the step's per-worker gradients, the guard's NaN multiplier
        # on the loss included; compiled once per arch
        if arch not in grad_fns:
            grad_fns[arch] = jax.jit(jax.vmap(jax.grad(
                lambda p, b, f, cfg=cfg: TF.loss_fn(cfg, p, b)[0]
                * jnp.where(f > 0, jnp.nan, 1.0)), in_axes=(None, 0, 0)))
        grad_fn = grad_fns[arch]
        params = PM.init_params(TF.param_defs(cfg), jax.random.PRNGKey(0))
        z = lambda: jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                                 params)
        opt = {"m": z(), "v": z()} if optimizer == "adamw" else ()
        pipe = LMWorkerPipeline(cfg, M, B, S, seed=1, byz=bcfg)
        out.update(flat(params, name + "/init"))
        key = jax.random.PRNGKey(0)
        for s in range(steps):
            tokens = pipe.batch(s)["tokens"]
            out[f"{name}/{s}/tokens"] = tokens
            act = None if actives is None else np.float32(actives[s])
            flt = np.float32(faults[s] if faults else [0] * M)
            if engine.get_spec(bcfg.aggregator).column is None:
                sel = selection(grad_fn, bcfg, params, tokens, act, flt)
                out.update({f"{name}/{s}/sel/{k}": v for k, v in sel.items()})
            args = [jax.device_put(params, psh), jax.device_put(opt, osh),
                    {"tokens": jax.device_put(jnp.asarray(tokens),
                                              bsh["tokens"])},
                    jnp.int32(s), jax.random.fold_in(key, s)]
            if bcfg.elastic:
                args.append(jnp.asarray(act))
            if guard:
                args += [jnp.float32(faults[s]), jnp.float32(-1.0)]
            with mesh:
                params, opt, met = bundle.step_fn(*args)
            params = jax.tree.map(np.asarray, params)
            opt = jax.tree.map(np.asarray, opt)
            out.update({f"{name}/{s}/met/{k}": np.asarray(v)
                        for k, v in met.items()})
            out.update(flat(params, f"{name}/{s}/params"))
    np.savez(%(OUT)r, **out)
    print("OK")
""")


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


def _port_G(cfg, params, tokens, faults):
    """The port's per-worker gradient stack [M, D], leaves in tree order,
    with the guard's NaN multiplier on a faulted worker's loss."""
    leaves = PM.tree_leaves(params)
    rows = []
    for i in range(M):
        rg = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(rg)

        def build(t):
            if isinstance(t, dict):
                return {k: build(t[k]) for k in sorted(t)}
            return next(it)
        loss, _ = TF.loss_fn(cfg, build(params),
                             {"tokens": torch.from_numpy(tokens[i])})
        if faults[i] > 0:
            loss = loss * float("nan")
        rows.append(torch.cat([g.reshape(-1) for g in
                               torch.autograd.grad(loss, rg)]))
    return torch.stack(rows)


def _margins(st, bcfg) -> dict:
    """How far the round's brsgd selection is from a tie: the gap
    between the kth score and the next lower one, and the smallest
    |l1 - 2T| relative to 2T."""
    sc = st.scores.numpy()
    k_idx, _ = ref.brsgd_rank_indices(M, bcfg.beta)
    srt = np.sort(sc)
    gaps = np.diff(srt)
    below = srt[srt < srt[k_idx]]
    two_t = 2.0 * float(st.threshold)
    return {"kth_score": float(srt[k_idx]),
            "kth_gap": float(srt[k_idx] - below.max()) if below.size
            else float("inf"),
            "smallest_score_gap": float(gaps.min()),
            "l1_margin": float(np.min(np.abs(st.l1.numpy() - two_t))
                               / two_t)}


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_train_step") / "steps.npz")
    code = _SNIPPET % {"M": M, "B": B, "S": S, "CASES": CASES, "OUT": path}
    assert "OK" in run_multidevice(code, n_devices=M, timeout=560)
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def port_steps(jax_steps):
    """Every case through the port's step on the CPU from the JAX
    case's initial params and batches: per step the params before and
    after, the metrics and the selection of the round."""
    out = {}
    for name, (arch, bkw, optimizer, lr, clip, steps, actives, faults,
               guard) in CASES.items():
        cfg = get_config(arch).reduced()
        bcfg = ByzantineConfig(**bkw)
        tcfg = TrainConfig(model=cfg, byzantine=bcfg, optimizer=optimizer,
                           lr=lr, grad_clip=clip, agg_scope="global",
                           agg_layout="gather",
                           recovery=RecoveryConfig(guard=guard))
        bundle = build_train_step(tcfg, M, "cpu")
        defs = TF.param_defs(cfg)
        params = _tree_from(jax_steps, f"{name}/init", defs)
        opt = bundle.opt_init(params)
        rows = []
        for s in range(steps):
            tokens = jax_steps[f"{name}/{s}/tokens"]
            act = None if actives is None else np.float32(actives[s])
            st = None
            if engine.get_spec(bcfg.aggregator).column is None:
                vf = None if act is None else torch.from_numpy(act)
                flt = faults[s] if faults else [0] * M
                G = threat.apply_dense(_port_G(cfg, params, tokens, flt),
                                       None, bcfg, active=vf)
                _, st = engine.aggregate_local(G, bcfg, return_state=True,
                                               valid=vf)
            before = [p.clone() for p in PM.tree_leaves(params)]
            args = [params, opt, {"tokens": tokens}, s, None]
            if bcfg.elastic:
                args.append(act)
            if guard:
                args += [np.float32(faults[s]), -1.0]
            params, opt, met = bundle.step_fn(*args)
            rows.append({"before": before, "met": met, "state": st,
                         "after": [p.clone() for p in PM.tree_leaves(params)],
                         "bcfg": bcfg, "paths": _leaf_paths(defs)})
        out[name] = rows
    return out


def _steps(name):
    return range(CASES[name][5])


@pytest.mark.parametrize("name", CASES)
def test_selection_matches_jax(name, jax_steps, port_steps):
    for s in _steps(name):
        row = port_steps[name][s]
        met = row["met"]
        for k in ("n_selected", "n_selected_min"):
            assert met[k] == float(jax_steps[f"{name}/{s}/met/{k}"]), (s, k)
        st = row["state"]
        if st is None:              # a column rule: every active worker
            continue
        want = jax_steps[f"{name}/{s}/sel/selected"]
        got = st.selected.numpy()
        info = _margins(st, row["bcfg"]) if hasattr(st, "scores") else {}
        print(name, s, "selected", got.astype(int), info)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {s} {info}")
        assert float(got.sum()) == met["n_selected"]


@pytest.mark.parametrize("name", CASES)
def test_metrics_match_jax(name, jax_steps, port_steps):
    for s in _steps(name):
        met = port_steps[name][s]["met"]
        want = {k[len(f"{name}/{s}/met/"):]: v for k, v in jax_steps.items()
                if k.startswith(f"{name}/{s}/met/")}
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
def test_params_match_jax(name, jax_steps, port_steps):
    optimizer, guard = CASES[name][2], CASES[name][8]
    for s in _steps(name):
        row = port_steps[name][s]
        want = [jax_steps[f"{name}/{s}/params{p}"] for p in row["paths"]]
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
        err = np.concatenate([np.abs(g - w).ravel()
                              for g, w in zip(got, want)])
        assert np.isfinite(err).all()
        tol = PARAM_TOL if optimizer != "adamw" or s == 0 else ADAMW_LATER_TOL
        over = float((err > tol * dp).mean())
        print(name, s, "max |dp|", dp, "max err", float(err.max()),
              "share over", tol, over)
        if optimizer == "adamw":
            assert over <= ADAMW_OUTLIERS, (s, over)
        else:
            assert float(err.max()) <= PARAM_TOL * dp, (s, float(err.max()),
                                                        dp)
