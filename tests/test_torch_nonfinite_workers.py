"""Non-finite workers that the rule leaves out, against the JAX package.

The JAX package's combine sums every row, weight 0 included: its plain
path ``ref.masked_mean_det`` as ``c + w·g``, its Pallas path
(``masked_mean_pallas``, ``select_mean_pallas``) as ``w @ g``.  A column
where an unselected worker holds NaN or ±inf therefore comes out NaN
(0·NaN and 0·inf are NaN).  The port's fixed round of every select rule
(``engine.aggregate_local``: mean, brsgd, krum, multi_krum, geomedian)
must give the same aggregate, NaN in the same places.

Inputs: honest rows around a shared gradient, a quarter scaled by -4,
and two workers with non-finite columns: worker 1 NaN in every 9th
column, worker 3 +inf and -inf in others and NaN in every 11th.  Both
get NaN scores, so krum keeps the first (worker 1, as ``jnp.argmin``)
and leaves worker 3 out; multi_krum ranks both last and brsgd's C1 drops
both (their l1 is not finite), though at m = 5 each keeps worker 1;
geomedian's weights are NaN everywhere, and the mean keeps both.

The elastic path zeroes an inactive worker's row before any statistic
in both packages, so an inactive worker whose row is NaN leaves the
aggregate finite.

Tolerances: exact against JAX's plain path (both sum rows in order),
within 1e-5 of the largest finite magnitude against its Pallas path
(``w @ g`` sums in another order) and for geomedian (its Weiszfeld loop
sums [m, m] products in another order); NaN positions always equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ByzantineConfig as JCfg
from repro.core import engine as jeng
from repro_torch.configs.base import ByzantineConfig as TCfg
from repro_torch.core import engine as teng

SELECT_RULES = ("mean", "brsgd", "krum", "multi_krum", "geomedian")
D = 131
RTOL = 1e-5


def close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    scale = max(np.abs(want[fin]).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=RTOL * scale)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def workers(m, seed):
    rng = np.random.default_rng(seed)
    G = (rng.normal(size=D) + 0.3 * rng.normal(size=(m, D))).astype(
        np.float32)
    G[m - m // 4:] *= np.float32(-4.0)
    G[1, ::9] = np.nan
    G[3, 2::9] = np.inf
    G[3, 5::9] = -np.inf
    G[3, 7::11] = np.nan
    return G


def jax_round(G, agg, use_pallas, valid=None):
    return jeng.aggregate_local(
        jnp.asarray(G), JCfg(aggregator=agg, alpha=0.25),
        use_pallas=use_pallas, d_blk=64, return_state=True,
        valid=None if valid is None else jnp.asarray(valid))


@pytest.mark.parametrize("rule", SELECT_RULES)
@pytest.mark.parametrize("m", (5, 12, 20))
def test_unselected_nonfinite_worker_gives_the_reference_nan(m, rule):
    G = workers(m, seed=m)
    got, st = teng.aggregate_local(
        torch.from_numpy(G), TCfg(aggregator=rule, alpha=0.25),
        return_state=True)
    got = got.numpy()
    want_plain, jst = jax_round(G, rule, use_pallas=False)
    want_pallas, _ = jax_round(G, rule, use_pallas=True)
    (close if rule == "geomedian" else exact)(got, want_plain)
    close(got, want_pallas)
    exact(st.selected, jst.selected)
    if rule in ("brsgd", "krum", "multi_krum"):
        # worker 3 is left out, and its non-finite columns are NaN
        assert not bool(st.selected[3])
        assert np.isnan(got[~np.isfinite(G[3])]).all()
    if rule in ("brsgd", "multi_krum") and m > 5:   # at m = 5 one is kept
        assert not bool(st.selected[1])
    assert np.isnan(got).any()
    # the mean keeps worker 3's ±inf; every other rule gives NaN there
    assert np.isinf(got).any() == (rule == "mean")


@pytest.mark.parametrize("rule", SELECT_RULES)
def test_inactive_nonfinite_worker_stays_out_of_the_elastic_round(rule):
    m = 12
    G = workers(m, seed=40)
    G[1] = np.nan
    G[3] = np.inf
    valid = np.ones(m, np.float32)
    valid[[1, 3]] = 0.0
    got = teng.aggregate_local(
        torch.from_numpy(G), TCfg(aggregator=rule, alpha=0.25),
        valid=torch.from_numpy(valid)).numpy()
    want, _ = jax_round(G, rule, use_pallas=False, valid=valid)
    assert np.isfinite(got).all() and np.isfinite(np.asarray(want)).all()
    (close if rule == "geomedian" else exact)(got, want)
