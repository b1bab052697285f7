"""The port's engine, aggregators and threat model against the JAX
package on the same numpy inputs (JAX with use_pallas=False and with
the Pallas kernels in interpret mode).

Tolerances: selections, order statistics and the row-order combines are
exact against the JAX plain path; against the Pallas path (matvec
combine, blockwise partials) floats agree within 1e-5 of the largest
reference magnitude.  Gaussian noise comes from different generators,
so its rows are checked in distribution only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ByzantineConfig as JCfg
from repro.core import aggregators as jagg
from repro.core import engine as jeng
from repro.core import threat as jthreat
from repro_torch.configs.base import ByzantineConfig as TCfg
from repro_torch.core import aggregators as tagg
from repro_torch.core import engine as teng
from repro_torch.core import threat as tthreat

RTOL = 1e-5
AGGS = ["brsgd", "mean", "median", "krum"]
DENSE_ATTACKS = ["scale", "negation", "sign_flip", "gaussian", "alie", "ipm"]


def close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def attacked(m=20, d=203, seed=0, n_byz=5, factor=1e10):
    """Honest rows around a shared gradient; the first n_byz rows
    scaled by ``factor`` (the paper's Gradient Scale magnitudes)."""
    rng = np.random.default_rng(seed)
    G = (rng.normal(size=d) + 0.3 * rng.normal(size=(m, d))).astype(np.float32)
    G[:n_byz] *= np.float32(factor)
    return G


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_aggregate_local_matches_jax(agg, use_pallas):
    G = attacked()
    cfg_kw = dict(aggregator=agg, alpha=0.25)
    got, tst = teng.aggregate_local(torch.from_numpy(G), TCfg(**cfg_kw),
                                    return_state=True)
    want, jst = jeng.aggregate_local(jnp.asarray(G), JCfg(**cfg_kw),
                                     use_pallas=use_pallas, return_state=True)
    (close if use_pallas else exact)(got, want)
    if agg == "median":
        assert tst is None and jst is None
        return
    exact(tst.selected, jst.selected)
    if agg == "brsgd":
        for f in ("c1", "c2", "scores"):
            exact(getattr(tst, f), getattr(jst, f))
        close(tst.l1, jst.l1)
        close(tst.threshold, jst.threshold)
    else:
        exact(tst.weights, jst.weights)


def test_brsgd_rejects_the_scaled_rows():
    G = attacked()
    _, st = teng.aggregate_local(torch.from_numpy(G), TCfg(), True)
    assert not bool(st.selected[:5].any()) and int(st.selected.sum()) > 0


@pytest.mark.parametrize("agg", AGGS)
def test_aggregator_functions_match_jax(agg):
    G = attacked(m=8, d=97, seed=1, n_byz=2, factor=-3.0)
    tcfg, jcfg = TCfg(aggregator=agg, alpha=0.25), JCfg(aggregator=agg,
                                                       alpha=0.25)
    got = tagg.aggregate(torch.from_numpy(G), tcfg)
    close(got, jagg.aggregate(jnp.asarray(G), jcfg))
    exact(got, tagg.AGGREGATORS[agg](torch.from_numpy(G), tcfg))
    exact(got, teng.aggregate_local(torch.from_numpy(G), tcfg))


def test_mean_is_the_row_order_mean():
    G = attacked(m=5, d=50, seed=2, factor=1.0)
    exact(tagg.mean(torch.from_numpy(G)), np.mean(G, axis=0))
    exact(tagg.cwise_median(torch.from_numpy(G)), np.median(G, axis=0))


def test_brsgd_select_matches_jax_state():
    rng = np.random.default_rng(3)
    sc = rng.integers(0, 30, 20).astype(np.float32)
    l1 = rng.random(20).astype(np.float32)
    got = teng.brsgd_select(torch.from_numpy(sc), torch.from_numpy(l1),
                            0.5, 0.0)
    want = jeng.brsgd_select(jnp.asarray(sc), jnp.asarray(l1), 0.5, 0.0)
    assert got._fields == want._fields
    for a, b in zip(got, want):
        exact(a, b)


def test_registry_and_unported_paths():
    """Every rule is ported, and the elastic valid= paths run."""
    assert teng.registered() == ("brsgd", "geomedian", "krum", "mean",
                                 "median", "multi_krum", "trimmed_mean")
    for name in teng.registered():
        t, j = teng.get_spec(name), jeng.get_spec(name)
        assert t.stats == j.stats
        assert (t.column is None) == (j.column is None)
    with pytest.raises(KeyError, match="unknown aggregator"):
        teng.get_spec("nope")
    with pytest.raises(ValueError, match="exactly one"):
        teng.AggregatorSpec("bad")
    with pytest.raises(ValueError, match="unknown stats"):
        teng.AggregatorSpec("bad", stats=frozenset({"x"}),
                            select=lambda *a: None)
    G = torch.zeros(4, 8)
    exact(teng.aggregate_local(G, TCfg(), valid=torch.ones(4)),
          np.zeros(8, np.float32))
    exact(teng.leaf_stats(G, {"l1"}, 4, valid=torch.ones(4))["l1"],
          np.zeros(4, np.float32))
    w, st, den = teng.resolve_select(teng.get_spec("mean"), {}, TCfg(), 4,
                                     "cpu")
    exact(w, np.ones(4))
    exact(st.selected, np.ones(4, bool))
    assert float(den) == 4.0


def test_config_checks_match_jax():
    for kw in ({"max_m": -1}, {"max_m": 4, "quorum": 5},
               {"quorum": 4, "alpha": 0.5}):
        with pytest.raises(ValueError):
            JCfg(**kw)
        with pytest.raises(ValueError):
            TCfg(**kw)
    assert TCfg(quorum=8, alpha=0.25).elastic and not TCfg().elastic


# ---------------------------------------------------------------------------
# threat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attack", DENSE_ATTACKS)
@pytest.mark.parametrize("alpha", [0.25, 0.45])
def test_apply_dense_matches_jax(attack, alpha):
    m, d = 20, 2000
    G = np.random.default_rng(4).normal(size=(m, d)).astype(np.float32)
    kw = dict(attack=attack, alpha=alpha)
    got = tthreat.apply_dense(torch.from_numpy(G),
                              torch.Generator().manual_seed(0), TCfg(**kw))
    want = jthreat.apply_dense(jnp.asarray(G), jax.random.PRNGKey(0),
                               JCfg(**kw))
    nb = int(alpha * m)
    exact(got[nb:], G[nb:])                         # honest rows untouched
    if attack == "gaussian":
        noise = got[:nb].numpy().astype(np.float64)
        std = JCfg().gaussian_std
        assert abs(noise.mean()) < 0.05 * std
        assert abs(noise.std() / std - 1.0) < 0.03
        return
    close(got, want)


def test_membership_and_noop_attacks():
    for m, alpha in ((20, 0.25), (20, 0.45), (8, 0.0), (5, 0.5)):
        cfg = dict(alpha=alpha, attack="scale")
        assert tthreat.n_byzantine(TCfg(**cfg), m) == \
            jthreat.n_byzantine(JCfg(**cfg), m)
        exact(tthreat.membership_mask(TCfg(**cfg), m),
              jthreat.membership_mask(JCfg(**cfg), m))
        exact(tthreat.data_membership(TCfg(**cfg), m, 3),
              jthreat.data_membership(JCfg(**cfg), m, 3))
    for policy in ("random", "resample"):
        mask = tthreat.membership_mask(TCfg(alpha=0.25, membership=policy),
                                       8, torch.Generator().manual_seed(1))
        assert int(mask.sum()) == 2
    with pytest.raises(ValueError, match="unknown membership"):
        tthreat.membership_mask(TCfg(alpha=0.25, membership="x"), 8)
    G = torch.randn(8, 5)
    for cfg in (TCfg(), TCfg(attack="scale"), TCfg(attack="label_flip",
                                                   alpha=0.5),
                TCfg(attack="scale", alpha=0.1)):
        assert tthreat.apply_dense(G, None, cfg) is G
    assert tthreat.registered() == jthreat.registered()
    for name in tthreat.registered():
        t, j = tthreat.get_spec(name), jthreat.get_spec(name)
        assert (t.scope, t.knows, t.shared_row) == (j.scope, j.knows,
                                                    j.shared_row)
    with pytest.raises(ValueError, match="unknown scope"):
        tthreat.AttackSpec("bad", scope="x")
    with pytest.raises(KeyError, match="unknown attack"):
        tthreat.get_spec("nope")
