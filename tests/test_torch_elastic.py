"""The port's elastic quorum path against the JAX package on the same
numpy inputs: the masked statistics, the streaming accumulator, keyed
membership, the elastic threat executor, the arrival schedule and the
robustness twin.

Tolerances: masks, counts, order statistics (medians, trimmed means,
cutoff indices) and integer scores exact; sums over d (l1, d2med, gram)
within rtol 1e-6 of the largest magnitude, because torch and XLA reduce
in another order; the streaming fold bit for bit against the port's own
bulk pass.  The robustness cells agree within rtol 1e-3 (150 steps of
float32 updates).  Keyed membership draws come from other generators
than jax.random's, so they are checked in distribution.
"""
import sys
from pathlib import Path

import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro.configs.base import ByzantineConfig as JCfg
from repro.core import engine as jeng
from repro.core import threat as jthreat
from repro.data import pipeline as jpipe
from repro.kernels import ref as jref
from repro_torch.configs.base import ByzantineConfig as TCfg
from repro_torch.core import engine as teng
from repro_torch.core import threat as tthreat
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SUM_RTOL = 1e-6
CELL_RTOL = 1e-3


def close(got, want, rtol=SUM_RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def mat(m=20, d=203, seed=0):
    return np.random.default_rng(seed).normal(size=(m, d)).astype(np.float32)


MASKS = {
    "random": (np.random.default_rng(5).random(20) < 0.6).astype(np.float32),
    "all_active": np.ones(20, np.float32),
    "one_active": np.eye(20, dtype=np.float32)[13],
}


# ---------------------------------------------------------------------------
# masked statistics
# ---------------------------------------------------------------------------

def pairwise_network(G):
    """The bitonic network one compare-exchange at a time, row by row:
    an independent reading of ``ref.bitonic_stages``."""
    m = G.shape[0]
    mp = ref.padded_workers(m)
    rows = [G[i] for i in range(m)]
    rows += [torch.full_like(rows[0], np.inf)] * (mp - m)
    for stage in ref.bitonic_stages(mp):
        for i, l, asc in stage:
            lo = torch.minimum(rows[i], rows[l])
            hi = torch.maximum(rows[i], rows[l])
            rows[i], rows[l] = (lo, hi) if asc else (hi, lo)
    return torch.stack(rows[:m])


@pytest.mark.parametrize("m", [5, 20])
def test_sorted_worker_stack_is_the_row_network(m):
    G = mat(m, 61, seed=1)
    G[3, ::4] = np.nan
    Gt = torch.from_numpy(G)
    exact(ref.sorted_worker_stack(Gt), pairwise_network(Gt))
    exact(torch.stack(ref.sorted_worker_rows(Gt)), pairwise_network(Gt))
    exact(ref.sorted_worker_stack(Gt), jref.sorted_worker_stack(jnp.asarray(G)))


def test_quantile_index_dyn_matches_jax():
    for q in (0.25, 0.5, 0.75):
        for n in range(1, 65):
            got = ref.quantile_index_dyn(q, torch.tensor(n))
            assert int(got) == int(jref.quantile_index_dyn(q, jnp.int32(n)))
            assert int(got) == ref.quantile_nearest_index(q, n)


@pytest.mark.parametrize("mask", list(MASKS))
def test_masked_refs_match_jax(mask):
    G = mat(seed=2)
    G[:4] *= np.float32(50.0)
    v = MASKS[mask]
    Gt, Gj = torch.from_numpy(G), jnp.asarray(G)
    vt, vj = torch.from_numpy(v), jnp.asarray(v)
    S = ref.masked_sorted_stack(Gt, vt)
    exact(S, jref.masked_sorted_stack(Gj, vj))
    na = int(v.sum())
    exact(ref.masked_median_from_stack(S, torch.tensor(na)),
          jref.masked_median_from_stack(jnp.asarray(S.numpy()),
                                        jnp.int32(na)))
    exact(ref.masked_cwise_median_ref(Gt, vt),
          jref.masked_cwise_median_ref(Gj, vj))
    exact(ops.cwise_median(Gt, valid=vt), jref.masked_cwise_median_ref(Gj, vj))
    for tf in (0.0, 0.1, 0.25, 0.49, 0.5):
        exact(ops.trimmed_mean(Gt, tf, valid=vt),
              jref.masked_trimmed_mean_ref(Gj, tf, vj))
    needs = ref.STAT_NAMES
    trefs = ref.masked_stat_refs(Gt, needs, vt)
    jrefs = jref.masked_stat_refs(Gj, needs, vj)
    for k in ("x", "v", "na", "mean_c", "majority_is_above", "med"):
        exact(trefs[k], jrefs[k])
    got = ops.fused_stats(Gt, needs, valid=vt)
    want = jref.masked_fused_stats_ref(Gj, needs, vj)
    exact(got["scores"], want["scores"])
    for k in ("l1", "d2med", "gram"):
        close(got[k], want[k])
    dropped = v == 0
    for k in needs:
        assert not np.asarray(got[k])[dropped].any(), k
    exact(got["gram"][:, dropped], 0.0)


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("beta,threshold", [(0.5, 0.0), (0.3, 0.0),
                                            (0.5, 1e-6)])
def test_masked_brsgd_select_matches_jax(mask, beta, threshold):
    rng = np.random.default_rng(6)
    sc = rng.integers(0, 40, 20).astype(np.float32)
    l1 = rng.random(20).astype(np.float32)
    v = MASKS[mask]
    got = ref.masked_brsgd_select(torch.from_numpy(sc), torch.from_numpy(l1),
                                  beta, threshold, torch.from_numpy(v))
    want = jref.masked_brsgd_select(jnp.asarray(sc), jnp.asarray(l1), beta,
                                    threshold, jnp.asarray(v))
    for a, b in zip(got, want):
        exact(a, b)
    assert not (np.asarray(got[0]) & (v == 0)).any()


def test_masked_median_of_a_nan_row_is_zero():
    """A NaN in an active row makes the whole sorted column NaN, and a
    non-finite median becomes 0, as in the JAX package."""
    G = mat(8, 30, seed=7)
    G[2, ::3] = np.nan
    v = np.ones(8, np.float32)
    v[5] = 0
    got = ref.masked_cwise_median_ref(torch.from_numpy(G), torch.from_numpy(v))
    exact(got, jref.masked_cwise_median_ref(jnp.asarray(G), jnp.asarray(v)))
    exact(got.numpy()[::3], 0.0)


# ---------------------------------------------------------------------------
# the streaming accumulator
# ---------------------------------------------------------------------------

@st.composite
def matrices(draw, min_m=3, max_m=12, min_d=1, max_d=40):
    m = draw(st.integers(min_m, max_m))
    d = draw(st.integers(min_d, max_d))
    seed = draw(st.integers(0, 2**31 - 1))
    G = np.random.default_rng(seed).normal(size=(m, d)).astype(np.float32)
    return G * np.float32(draw(st.sampled_from([1e-3, 1.0, 1e4])))


@settings(max_examples=40, deadline=None)
@given(matrices(), st.data())
def test_streaming_fold_bitexact_with_bulk(G, data):
    """Folding the stat partials over any permutation and partition of
    the worker axis, with workers that never arrive, equals the bulk
    masked pass bit for bit for every subset of STAT_NAMES."""
    m, d = G.shape
    needs = tuple(sorted(data.draw(
        st.sets(st.sampled_from(ref.STAT_NAMES), min_size=1))))
    perm = data.draw(st.permutations(list(range(m))))
    n_arrived = data.draw(st.integers(1, m))
    arrived = perm[:n_arrived]
    cuts = (sorted(data.draw(st.sets(st.integers(1, n_arrived - 1),
                                     max_size=3)))
            if n_arrived > 1 else [])
    bounds = [0, *cuts, n_arrived]
    arrival = np.zeros((len(bounds) - 1, m), np.float32)
    for b, (a, e) in enumerate(zip(bounds, bounds[1:])):
        arrival[b, arrived[a:e]] = 1.0
    valid = arrival.sum(axis=0)
    state = teng.stream_leaf_stats(torch.from_numpy(G), needs, m,
                                   torch.from_numpy(arrival))
    bulk = teng.leaf_stats(torch.from_numpy(G), needs, m,
                           valid=torch.from_numpy(valid))
    for k in needs:
        exact(state.stats[k], bulk[k])
    exact(state.valid, valid)


def test_fold_order_and_quorum_helpers():
    G = torch.from_numpy(mat(6, 17, seed=8))
    needs = ("gram", "l1", "scores")
    v = torch.tensor([1, 1, 0, 1, 1, 0], dtype=torch.float32)
    b1 = torch.tensor([1, 0, 0, 1, 0, 0], dtype=torch.float32)
    b2 = v - b1
    refs = ops.masked_stat_refs(G, needs, v)
    p1 = teng.leaf_stats(G, needs, 6, valid=v, rows=b1, refs=refs)
    p2 = teng.leaf_stats(G, needs, 6, valid=v, rows=b2, refs=refs)
    s0 = teng.init_stream(needs, 6)
    a = teng.fold_stats(teng.fold_stats(s0, p1, b1), p2, b2)
    b = teng.fold_stats(teng.fold_stats(s0, p2, b2), p1, b1)
    for k in needs:
        exact(a.stats[k], b.stats[k])
    exact(a.valid, v)
    assert bool(teng.quorum_met(a.valid, 4)) and not bool(
        teng.quorum_met(a.valid, 5))
    buf, val = teng.fold_arrivals(torch.zeros(6, 17), torch.zeros(6), G, b1)
    exact(buf[b1 > 0], G[b1 > 0])
    exact(buf[b1 == 0], 0.0)
    exact(val, b1)


def test_stream_aggregate_takes_quorum_prefix():
    """Selection fires once quorum workers have arrived: later arrivals
    are dropped, n_selected <= quorum, and the aggregate equals the
    masked local pass over exactly the quorum prefix (and JAX's)."""
    m, d, q = 10, 29, 6
    G = np.random.default_rng(0).normal(size=(m, d)).astype(np.float32)
    arrival = np.zeros((3, m), np.float32)
    arrival[0, [2, 5, 7, 9]] = 1
    arrival[1, [0, 1, 3]] = 1
    arrival[2, [4, 6, 8]] = 1
    active = teng.arrival_active(torch.from_numpy(arrival), q)
    exact(active, jeng.arrival_active(jnp.asarray(arrival), q))
    assert set(np.flatnonzero(active.numpy())) == {2, 5, 7, 9, 0, 1}
    exact(teng.arrival_active(torch.from_numpy(arrival), 0), np.ones(m))
    for agg in teng.registered():
        cfg = dict(aggregator=agg, alpha=0.25, quorum=q, max_m=m)
        out, tst = teng.stream_aggregate(torch.from_numpy(G), TCfg(**cfg),
                                         torch.from_numpy(arrival), None,
                                         True)
        sel = tst.selected.numpy()
        assert sel.sum() <= q and not (sel & (active.numpy() == 0)).any()
        want, _ = teng.aggregate_local(torch.from_numpy(G), TCfg(**cfg),
                                       return_state=True, valid=active)
        exact(out, want)
        jout = jeng.stream_aggregate(jnp.asarray(G), JCfg(**cfg),
                                     jnp.asarray(arrival))
        if agg == "geomedian":
            close(out, jout, 1e-5)
        else:
            exact(out, jout)


# ---------------------------------------------------------------------------
# membership and the elastic threat executor
# ---------------------------------------------------------------------------

def test_n_byzantine_counts_in_float32():
    for alpha in (0.1, 0.2, 0.25, 0.3, 0.45):
        cfg = dict(alpha=alpha)
        for na in range(0, 65):
            got = tthreat.n_byzantine(TCfg(**cfg), 64, torch.tensor(na))
            want = jthreat.n_byzantine(JCfg(**cfg), 64, jnp.int32(na))
            assert int(got) == int(want), (alpha, na)


@pytest.mark.parametrize("attack", ["scale", "alie", "negation", "gaussian"])
def test_apply_dense_active_matches_jax_prefix(attack):
    m, d = 20, 300
    G = mat(m, d, seed=9)
    act = MASKS["random"]
    kw = dict(attack=attack, alpha=0.25, quorum=15, max_m=20)
    got = tthreat.apply_dense(torch.from_numpy(G),
                              torch.Generator().manual_seed(0), TCfg(**kw),
                              active=torch.from_numpy(act))
    want = jthreat.apply_dense(jnp.asarray(G), jax.random.PRNGKey(0),
                               JCfg(**kw), active=jnp.asarray(act))
    mask = tthreat.membership_mask(TCfg(**kw), m,
                                   active=torch.from_numpy(act)).numpy()
    exact(mask, jthreat.membership_mask(JCfg(**kw), m,
                                        active=jnp.asarray(act)))
    assert mask.sum() == int(0.25 * act.sum()) and not (mask & (act == 0)).any()
    exact(got.numpy()[~mask], G[~mask])          # honest and dropped rows
    if attack == "gaussian":
        assert np.abs(got.numpy()[mask]).std() > 50.0
        return
    close(got, want, 1e-6)


@pytest.mark.parametrize("policy", ["random", "resample"])
def test_keyed_membership_draws(policy):
    """⌊α·n⌋ byzantines every draw, all of them active; fixed across
    steps under "random", varying under "resample" (from the step's
    generator, or from (byz_seed, step) in the pipelines)."""
    m = 20
    cfg = TCfg(alpha=0.25, membership=policy, byz_seed=3)
    act = torch.from_numpy(MASKS["random"])
    na = int(act.sum())
    draws = {"full": set(), "active": set(), "data": set()}
    for step in range(12):
        gen = torch.Generator().manual_seed(100 + step)
        a = tthreat.membership_mask(cfg, m, gen)
        b = tthreat.membership_mask(cfg, m, gen, active=act)
        c = tthreat.data_membership(cfg, m, step)
        assert int(a.sum()) == int(c.sum()) == 5
        assert int(b.sum()) == int(0.25 * na) and not (b & (act == 0)).any()
        exact(c, tthreat.data_membership(cfg, m, step))      # reproducible
        for k, x in (("full", a.numpy()), ("active", b.numpy()), ("data", c)):
            draws[k].add(x.tobytes())
    for k, seen in draws.items():
        if policy == "random":
            assert len(seen) == 1, k
        else:
            assert len(seen) > 6, k
    if policy == "resample":
        with pytest.raises(ValueError, match="resample"):
            tthreat.membership_mask(cfg, m)


def test_stall_spec_and_scopes():
    t, j = tthreat.get_spec("stall"), jthreat.get_spec("stall")
    assert (t.scope, t.knows, t.shared_row) == (j.scope, j.knows,
                                                j.shared_row)
    d = np.arange(6, dtype=float)
    is_byz = np.array([1, 0, 0, 1, 0, 0], bool)
    exact(t.delay(d, is_byz, TCfg()), j.delay(d, is_byz, JCfg()))
    with pytest.raises(ValueError, match="timing specs set delay"):
        tthreat.AttackSpec("bad", scope="timing", delay=None)
    with pytest.raises(ValueError, match="timing specs set delay"):
        tthreat.AttackSpec("bad", corrupt=lambda *a: 0, delay=lambda *a: 0)
    G = torch.randn(8, 5)
    assert tthreat.apply_dense(G, None, TCfg(attack="stall", alpha=0.25)) is G


# ---------------------------------------------------------------------------
# the arrival schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("straggle,attack", [("none", "none"),
                                             ("exp", "none"),
                                             ("pareto", "none"),
                                             ("exp", "stall"),
                                             ("none", "stall")])
def test_arrival_schedule_matches_jax(straggle, attack):
    kw = dict(attack=attack, alpha=0.25 if attack != "none" else 0.0,
              quorum=15, max_m=20)
    t = tpipe.ArrivalSchedule(20, 15, straggle, 0.5, TCfg(**kw), seed=4)
    j = jpipe.ArrivalSchedule(20, 15, straggle, 0.5, JCfg(**kw), seed=4)
    for step in range(5):
        exact(t.delays(step), j.delays(step))
        exact(t.active(step), j.active(step))
    if attack == "stall":
        assert not t.active(0)[:5].any()


def test_parse_straggle_and_attack_specs_match_jax():
    for arg in ("none", "exp", "exp:0.5", "pareto:2"):
        assert tpipe.parse_straggle(arg) == jpipe.parse_straggle(arg)
    for bad in ("gauss", "none:1", "exp:x", "exp:-1"):
        with pytest.raises(ValueError) as te:
            tpipe.parse_straggle(bad)
        with pytest.raises(ValueError) as je:
            jpipe.parse_straggle(bad)
        assert str(te.value) == str(je.value)
    for attack, alpha in (("stall", 0.25), ("stall", 0.0), ("scale", 0.25),
                          ("label_flip", 0.25)):
        kw = dict(attack=attack, alpha=alpha)
        for fn in ("timing_attack_spec", "data_attack_spec"):
            got = getattr(tpipe, fn)(TCfg(**kw))
            want = getattr(jpipe, fn)(JCfg(**kw))
            assert (got is None) == (want is None)
    with pytest.raises(ValueError, match="quorum"):
        tpipe.ArrivalSchedule(20, 0)


# ---------------------------------------------------------------------------
# the slice: the robustness twin against benchmarks/robustness.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("agg,attack,quorum", [
    ("brsgd", "scale", 20), ("trimmed_mean", "alie", 20),
    ("brsgd", "stall", 20), ("multi_krum", "negation", 15),
    ("geomedian", "ipm", 15)])
def test_robustness_cells_match_jax(agg, attack, quorum):
    from benchmarks import robustness as jrob
    from repro_torch.paper import robustness as trob
    assert (trob.ATTACKS, trob.AGGS, trob.QUORUMS) == \
        (jrob.ATTACKS, jrob.AGGS, jrob.QUORUMS)
    assert (trob.D, trob.STEPS, trob.LR, trob.M, trob.N) == \
        (jrob.D, jrob.STEPS, jrob.LR, jrob.M, jrob.N)
    got = trob.run(agg, attack, quorum=quorum, device="cpu")
    want = jrob.run(agg, attack, quorum=quorum)
    np.testing.assert_allclose(got, want, rtol=CELL_RTOL)
    assert got < 0.1


def test_robustness_claim_reads_the_matrix():
    from repro_torch.paper import robustness as trob
    errs = {(q, a, t): 0.03 for q in trob.QUORUMS for a in trob.AGGS
            for t in trob.ATTACKS}
    errs[(20, "mean", "scale")] = float("inf")
    ok, lines = trob.claim(errs, 0.026)
    assert ok and lines[-1].endswith("PASS")
    errs[(15, "brsgd", "stall")] = 1.0
    ok, lines = trob.claim(errs, 0.026)
    assert not ok and lines[-1].endswith("FAIL")
