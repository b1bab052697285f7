"""The port's full aggregator registry against the JAX package on the
same numpy inputs: B5's plain version (``ref.trimmed_mean_ref``) against
``trimmed_mean_pallas`` in interpret mode and the JAX reference, and
every registered rule through ``aggregate_local``, full and masked.

Tolerances: the trimmed mean equals the JAX reference bit for bit (the
same sorted rows, summed in the same order, divided by the same float);
against the Pallas kernel it is within 1 ulp, because the interpreted
kernel divides by a Python int that XLA turns into a multiply by its
reciprocal (exact only for a power-of-two count).  Every aggregate,
selection and weight vector is exact against the JAX plain path, except
geomedian: its Weiszfeld loop runs [m, m] matrix-vector products that
sum in another order, so its weights and aggregate are held within
rtol 1e-5 (relative to the largest magnitude; values reach ~1e25 under
the 1e10 scale attack); and brsgd's l1 sums and the threshold read from
them, which torch and XLA reduce over d in another order (rtol 1e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ByzantineConfig as JCfg
from repro.core import aggregators as jagg
from repro.core import engine as jeng
from repro.kernels import ref as jref
from repro.kernels.brsgd_stats import trimmed_mean_pallas
from repro_torch.configs.base import ByzantineConfig as TCfg
from repro_torch.core import aggregators as tagg
from repro_torch.core import engine as teng
from repro_torch.kernels import ops, ref

GEOMEDIAN_RTOL = 1e-5
SUM_RTOL = 1e-6


def close(got, want, rtol=GEOMEDIAN_RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def attacked(m=20, d=203, seed=0, n_byz=5, factor=1e10):
    """Honest rows around a shared gradient; the first n_byz rows scaled
    by ``factor`` (the paper's Gradient Scale magnitudes)."""
    rng = np.random.default_rng(seed)
    G = (rng.normal(size=d) + 0.3 * rng.normal(size=(m, d))).astype(np.float32)
    G[:n_byz] *= np.float32(factor)
    return G


# ---------------------------------------------------------------------------
# B5's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [5, 8, 20])
@pytest.mark.parametrize("trim_frac", [0.0, 0.1, 0.25, 0.49, 0.5])
def test_trimmed_mean_ref_matches_jax(m, trim_frac):
    G = (np.random.default_rng(m).normal(size=(m, 203)) * 3).astype(np.float32)
    got = ref.trimmed_mean_ref(torch.from_numpy(G), trim_frac).numpy()
    exact(got, jref.trimmed_mean_ref(jnp.asarray(G), trim_frac))
    pallas = np.asarray(trimmed_mean_pallas(jnp.asarray(G), trim_frac,
                                            d_blk=64))    # ragged: pads d
    np.testing.assert_array_max_ulp(got, pallas, maxulp=1)
    k = ref.trim_k(trim_frac, m)
    if (m - 2 * k) & (m - 2 * k - 1) == 0:                # power of two
        exact(got, pallas)
    exact(ops.trimmed_mean(torch.from_numpy(G), trim_frac), got)


def test_trimmed_mean_ref_at_m64_matches_a_sort():
    """JAX-free: at m = 64 (no stack switch in the port) the network's
    trimmed mean equals the mean of torch.sort's middle rows, summed in
    the same row order."""
    G = torch.from_numpy(np.random.default_rng(64).normal(
        size=(64, 301)).astype(np.float32))
    for trim_frac in (0.1, 0.25, 0.49, 0.5):
        k = ref.trim_k(trim_frac, 64)
        S = torch.sort(G, dim=0).values
        want = S[k]
        for i in range(k + 1, 64 - k):
            want = want + S[i]
        exact(ref.trimmed_mean_ref(G, trim_frac),
              want / torch.tensor(64.0 - 2 * k))


def test_trimmed_mean_trims_the_outliers_and_propagates_nan():
    G = attacked(m=8, d=50, n_byz=1)
    got = ref.trimmed_mean_ref(torch.from_numpy(G), 0.125).numpy()
    assert np.abs(got).max() < 10.0
    G[3, ::7] = np.nan
    got = ref.trimmed_mean_ref(torch.from_numpy(G), 0.125).numpy()
    exact(np.isnan(got), np.arange(50) % 7 == 0)
    exact(got, jref.trimmed_mean_ref(jnp.asarray(G), 0.125))


# ---------------------------------------------------------------------------
# the registry, full and masked
# ---------------------------------------------------------------------------

def test_registry_matches_jax():
    assert teng.registered() == jeng.registered()
    assert len(teng.registered()) == 7
    for name in teng.registered():
        t, j = teng.get_spec(name), jeng.get_spec(name)
        assert t.stats == j.stats
        assert (t.column is None) == (j.column is None)
    assert set(tagg.AGGREGATORS) == set(jagg.AGGREGATORS)
    assert (teng.GEOMEDIAN_ITERS, teng.GEOMEDIAN_EPS) == \
        (jeng.GEOMEDIAN_ITERS, jeng.GEOMEDIAN_EPS)


MASKS = {
    "full": None,
    "random": (np.random.default_rng(11).random(20) < 0.7).astype(np.float32),
    "all_active": np.ones(20, np.float32),
    "one_active": np.eye(20, dtype=np.float32)[7],
}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("agg", sorted(jeng.registered()))
def test_aggregate_local_matches_jax(agg, mask):
    G = attacked()
    v = MASKS[mask]
    kw = dict(aggregator=agg, alpha=0.25)
    got, tst = teng.aggregate_local(
        torch.from_numpy(G), TCfg(**kw), return_state=True,
        valid=None if v is None else torch.from_numpy(v))
    want, jst = jeng.aggregate_local(
        jnp.asarray(G), JCfg(**kw), use_pallas=False, return_state=True,
        valid=None if v is None else jnp.asarray(v))
    (close if agg == "geomedian" else exact)(got, want)
    assert type(tst).__name__ == type(jst).__name__
    if jst is None:
        return
    assert tst._fields == jst._fields
    exact(tst.selected, jst.selected)
    if v is not None:
        assert not (np.asarray(tst.selected) & (v == 0)).any()
    if agg == "brsgd":
        for f in ("c1", "c2", "scores"):
            exact(getattr(tst, f), getattr(jst, f))
        for f in ("l1", "threshold"):
            close(getattr(tst, f), getattr(jst, f), SUM_RTOL)
    else:
        (close if agg == "geomedian" else exact)(tst.weights, jst.weights)


@pytest.mark.parametrize("agg", ["trimmed_mean", "multi_krum", "geomedian"])
def test_new_aggregator_functions_match_jax(agg):
    G = attacked(m=8, d=97, seed=1, n_byz=2, factor=-3.0)
    tcfg, jcfg = TCfg(aggregator=agg, alpha=0.25), JCfg(aggregator=agg,
                                                       alpha=0.25)
    got = tagg.aggregate(torch.from_numpy(G), tcfg)
    want = jagg.aggregate(jnp.asarray(G), jcfg)
    (close if agg == "geomedian" else exact)(got, want)
    exact(got, teng.aggregate_local(torch.from_numpy(G), tcfg))


def test_bound_select_options_match_jax():
    G = attacked(m=8, d=97, seed=2, n_byz=2)
    Gt, Gj = torch.from_numpy(G), jnp.asarray(G)
    cfg = dict(aggregator="multi_krum", alpha=0.25)
    for n in (1, 3, 8):
        exact(tagg.multi_krum(Gt, TCfg(**cfg), n_select=n),
              jagg.multi_krum(Gj, JCfg(**cfg), n_select=n))
    for iters, eps in ((1, 1e-6), (4, 1e-3)):
        close(tagg.geometric_median(Gt, TCfg(), iters=iters, eps=eps),
              jagg.geometric_median(Gj, JCfg(), iters=iters, eps=eps))
    spec = teng.spec_with("multi_krum", n_select=2)
    w, _ = spec.select({"gram": Gt @ Gt.T}, TCfg(**cfg), 8)
    assert float(w.sum()) == 2.0


def test_multi_krum_breaks_score_ties_by_worker_index():
    """Identical attacker rows tie on their krum scores: the stable
    argsort keeps the lower indices, as jnp.argsort does."""
    G = np.tile(np.linspace(-1, 1, 30, dtype=np.float32), (8, 1))
    G[4:] += 0.5
    cfg = dict(aggregator="multi_krum", alpha=0.25)
    _, tst = teng.aggregate_local(torch.from_numpy(G), TCfg(**cfg), True)
    _, jst = jeng.aggregate_local(jnp.asarray(G), JCfg(**cfg),
                                  use_pallas=False, return_state=True)
    exact(tst.weights, jst.weights)
