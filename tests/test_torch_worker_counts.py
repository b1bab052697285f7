"""Every registered rule at worker counts without a tuned kernel instance
(m in 1, 2, 3, 12, 33, 63: each runs a bucket instance on the card)
against the JAX package on the same numpy inputs, with one worker's
gradient NaN in every third column: ``engine.aggregate_local``'s fixed
round at each of them, and the elastic path (``stream_aggregate`` over
arrival buckets, the masked pass on the quorum) at m = 3, 12 and 33.  The JAX side runs as its own tests run it: its plain path, and
for brsgd's fixed round the Pallas fast path (brsgd_partials_pallas ->
select_mean_pallas, interpret mode), which the port's brsgd follows.

What is compared: the selection (``selected``, the weights; brsgd's c1,
c2 and scores) against JAX's; the aggregate against JAX's own aggregate,
NaN in the same places (both combines sum every row, weight 0 included,
so an unselected NaN worker makes its columns NaN), exactly where JAX
takes its plain row-order combine and within 1e-5 elsewhere where brsgd's
fixed round takes the Pallas combine (``w @ g``, not in row order at m =
63); the column rules' aggregates against JAX's directly.

Tolerances: exact, except geomedian's weights and aggregate (its
Weiszfeld loop sums [m, m] products in another order, as in
test_torch_registry.py) and the trimmed mean (XLA sums the kept sorted
rows and divides by m - 2k in its own way: up to 38 ulp of a value near
zero at m = 33), each within 1e-5 of the largest magnitude.  The kernels' own agreement with these plain versions
at every m in 1..64 is held on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ByzantineConfig as JCfg
from repro.core import engine as jeng
from repro_torch.configs.base import ByzantineConfig as TCfg
from repro_torch.core import engine as teng
from repro_torch.kernels import brsgd_stats as kern

NEW_M = (1, 2, 3, 12, 33, 63)
D = 97
RTOL = 1e-5


def close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    scale = max(np.abs(want[fin]).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=RTOL * scale)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def workers(m, seed):
    """Honest rows around a shared gradient, a quarter scaled by -4, and
    one worker's gradient NaN in every third column."""
    rng = np.random.default_rng(seed)
    G = (rng.normal(size=D) + 0.3 * rng.normal(size=(m, D))).astype(
        np.float32)
    G[: m // 4] *= np.float32(-4.0)
    G[(m - 1) // 2, ::3] = np.nan
    return G


def test_the_new_counts_run_bucket_instances():
    assert not set(NEW_M) & set(kern.TUNED_M)
    assert {kern.instance_rows(m) for m in NEW_M} == {2, 4, 16, 64}


def jax_round(G, agg, v, **kw):
    """JAX's aggregate_local as its tests run it (brsgd's fixed round on
    the Pallas fast path in interpret mode)."""
    fast = agg == "brsgd" and v is None
    return jeng.aggregate_local(
        jnp.asarray(G), JCfg(aggregator=agg, alpha=0.25, **kw),
        use_pallas=fast, d_blk=64, return_state=True,
        valid=None if v is None else jnp.asarray(v))


def check_round(G, agg, v, got, tst, want, jst):
    cmp = close if agg == "geomedian" else exact
    if agg in ("median", "trimmed_mean", "mean"):
        if agg == "trimmed_mean":
            close(got, want)
        else:
            exact(got, want)
        return
    exact(tst.selected, jst.selected)
    if agg == "brsgd":
        for f in ("c1", "c2", "scores"):
            exact(getattr(tst, f), getattr(jst, f))
    else:
        cmp(tst.weights, jst.weights)
    if agg == "brsgd" and v is None:    # JAX's Pallas combine, w @ g
        cmp = close
    cmp(got, want)
    exact(np.isnan(np.asarray(got)), np.isnan(np.asarray(want)))


@pytest.mark.parametrize("agg", sorted(jeng.registered()))
@pytest.mark.parametrize("m", NEW_M)
def test_aggregate_local_matches_jax_at_untuned_worker_counts(m, agg):
    G = workers(m, seed=m)
    got, tst = teng.aggregate_local(
        torch.from_numpy(G), TCfg(aggregator=agg, alpha=0.25),
        return_state=True)
    want, jst = jax_round(G, agg, None)
    check_round(G, agg, None, got, tst, want, jst)


@pytest.mark.parametrize("m", (3, 12, 33))
def test_stream_aggregate_matches_jax_at_untuned_worker_counts(m):
    """The elastic stream over 3 arrival buckets, quorum m - m // 4, for
    every rule: equal to JAX's stream, and to the port's masked round on
    the quorum's workers."""
    G = workers(m, seed=100 + m)
    rng = np.random.default_rng(m)
    arrival = np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=m)].T
    q = max(1, m - m // 4)
    for agg in sorted(jeng.registered()):
        got, tst = teng.stream_aggregate(
            torch.from_numpy(G), TCfg(aggregator=agg, alpha=0.25, quorum=q),
            torch.from_numpy(arrival), return_state=True)
        want, jst = jeng.stream_aggregate(
            jnp.asarray(G), JCfg(aggregator=agg, alpha=0.25, quorum=q),
            jnp.asarray(arrival), return_state=True)
        active = np.asarray(teng.arrival_active(torch.from_numpy(arrival), q))
        check_round(G, agg, active, got, tst, want, jst)
