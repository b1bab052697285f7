"""Parity of the port's plain kernel versions (repro_torch.kernels.ref)
with the JAX package's oracles (repro.kernels.ref) and its Pallas
kernels in interpret mode, on the same numpy inputs.

Tolerances: scores, masks, medians, order statistics and the row-order
means are exact; l1/d2med/gram/matvec means agree within 1e-5 of the
largest reference magnitude (the two frameworks reduce in other orders).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.brsgd_stats import fused_stats_pallas
from repro_torch.kernels import ref as tref

SUBSETS = [c for r in range(1, 5)
           for c in itertools.combinations(jref.STAT_NAMES, r)]
RTOL = 1e-5


def close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def mat(m, d, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(m, d)) * scale
            ).astype(np.float32)


def test_bitonic_stages_and_padding_match():
    for n in (2, 4, 8, 16, 32, 64):
        assert tref.bitonic_stages(n) == jref.bitonic_stages(n)
    assert [tref.padded_workers(m) for m in (1, 2, 3, 5, 8, 20, 33)] == \
        [2, 2, 4, 8, 8, 32, 64]


@pytest.mark.parametrize("m", [5, 8, 20])
@pytest.mark.parametrize("needs", SUBSETS, ids=lambda n: "+".join(n))
def test_fused_stats_ref_matches_jax_ref(m, needs):
    G = mat(m, 203, seed=m)                                   # ragged d
    got = tref.fused_stats_ref(torch.from_numpy(G), needs)
    want = jref.fused_stats_ref(jnp.asarray(G), needs)
    assert set(got) == set(needs)
    for n in needs:
        if n == "scores":
            exact(got[n], want[n])
        else:
            close(got[n], want[n])


@pytest.mark.parametrize("needs", SUBSETS, ids=lambda n: "+".join(n))
def test_fused_stats_ref_matches_pallas_interpret(needs):
    """d = 203 with d_blk = 64: the Pallas kernel zero-pads 53 columns
    and subtracts their +1 score; the port has no pad columns."""
    G = mat(8, 203, seed=3)
    got = tref.fused_stats_ref(torch.from_numpy(G), needs)
    want = fused_stats_pallas(jnp.asarray(G), needs, d_blk=64)
    for n in needs:
        if n == "scores":
            exact(got[n], want[n])
        else:
            close(got[n], want[n])


@pytest.mark.parametrize("m", [4, 5, 7, 8, 20])
def test_order_statistics_are_exact(m):
    G = mat(m, 157, seed=10 + m)
    Gt = torch.from_numpy(G)
    exact(tref.cwise_median_ref(Gt), jref.cwise_median_ref(jnp.asarray(G)))
    exact(tref.cwise_median_ref(Gt), np.median(G, axis=0))
    rows = tref.sorted_worker_rows(Gt)
    exact(torch.stack(rows), np.sort(G, axis=0))
    exact(tref.column_mean_ref(Gt), jref.column_mean_ref(jnp.asarray(G)))
    exact(tref.majority_score_ref(Gt),
          jref.majority_score_ref(jnp.asarray(G)))
    close(tref.l1_to_median_ref(Gt), jref.l1_to_median_ref(jnp.asarray(G)))


@pytest.mark.parametrize("m", [4, 5, 7, 8, 16, 20, 32, 64])
def test_one_nan_makes_every_sorted_row_nan(m):
    """Every output of the sorting network depends on every input, so
    one NaN anywhere in a column turns the whole sorted column NaN, as
    in the JAX package — the CUDA kernels test each column once for NaN
    on this ground instead of at every compare-exchange."""
    G = mat(m, m + 2, seed=m)
    for j in range(m):
        G[j, j] = np.nan                       # column j: NaN in row j
    want = jref.sorted_worker_rows(jnp.asarray(G))
    rows = torch.stack(tref.sorted_worker_rows(torch.from_numpy(G)))
    exact(rows, np.stack(want))
    assert rows[:, :m].isnan().all() and not rows[:, m:].isnan().any()


def test_brsgd_stats_ref_matches_jax():
    G = mat(20, 300, seed=4)
    got = tref.brsgd_stats_ref(torch.from_numpy(G))
    want = jref.brsgd_stats_ref(jnp.asarray(G))
    exact(got[0], want[0])           # median
    exact(got[1], want[1])           # row-order mean
    exact(got[2], want[2])           # scores
    close(got[3], want[3])           # l1


def test_constant_column_scores_everyone():
    G = np.ones((5, 4), np.float32)
    exact(tref.majority_score_ref(torch.from_numpy(G)), np.full(5, 4.0))


@pytest.mark.parametrize("kind", ["bool", "weights", "empty", "full"])
def test_masked_means_match_jax(kind):
    G = mat(8, 97, seed=5)
    rng = np.random.default_rng(6)
    mask = {"bool": rng.random(8) < 0.5,
            "weights": rng.random(8).astype(np.float32),
            "empty": np.zeros(8, bool),
            "full": np.ones(8, bool)}[kind]
    Gt, mt = torch.from_numpy(G), torch.from_numpy(mask)
    close(tref.masked_mean_ref(Gt, mt),
          jref.masked_mean_ref(jnp.asarray(G), jnp.asarray(mask)))
    det = tref.masked_mean_det(Gt, mt)
    want = jref.masked_mean_det(jnp.asarray(G), jnp.asarray(mask))
    if kind == "weights":
        close(det, want)
    else:
        exact(det, want)
    if kind == "full":
        exact(det, tref.column_mean_ref(Gt))
    if kind == "empty":
        exact(det, np.zeros(97, np.float32))


def test_masked_mean_det_skips_nonfinite_dropped_rows():
    """A dropped row is not skipped: every row is summed, weight 0
    included (0·inf is NaN), as the JAX c + w·g does; finite dropped rows
    leave the bits of the kept rows' mean."""
    G = mat(4, 6, seed=7)
    w = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    exact(tref.masked_mean_det(torch.from_numpy(G), torch.from_numpy(w)),
          jref.masked_mean_det(jnp.asarray(G[[0, 2, 3]]), jnp.ones(3, bool)))
    G[1, ::2] = np.inf
    G[1, 1] = np.nan
    got = tref.masked_mean_det(torch.from_numpy(G), torch.from_numpy(w))
    exact(got, jref.masked_mean_det(jnp.asarray(G), jnp.asarray(w)))
    exact(np.isnan(got.numpy()), ~np.isfinite(G[1]))


def test_rank_select_and_quantile_index():
    rng = np.random.default_rng(8)
    for m in (4, 5, 7, 20):
        x = rng.integers(0, 4, size=m).astype(np.float32)     # many ties
        for k in range(m):
            assert float(tref.rank_select(torch.from_numpy(x), k)) == \
                float(jref.rank_select(jnp.asarray(x), k)) == np.sort(x)[k]
        for q in (0.0, 0.25, 0.5, 0.75, 1.0):
            assert tref.quantile_nearest_index(q, m) == \
                jref.quantile_nearest_index(q, m)
    assert tref.quantile_nearest_index(0.5, 4) == 1          # half DOWN
    for frac, m in ((0.1, 20), (0.5, 4), (0.49, 5), (0.0, 8)):
        assert tref.trim_k(frac, m) == jref.trim_k(frac, m)


@pytest.mark.parametrize("beta,threshold", [(0.5, 0.0), (0.25, 0.0),
                                            (0.5, 3.0), (0.9, 1e-9)])
def test_brsgd_selection_matches_jax(beta, threshold):
    rng = np.random.default_rng(9)
    scores = rng.integers(0, 50, size=20).astype(np.float32)
    l1 = rng.random(20).astype(np.float32) * 10
    got = tref.brsgd_select_mask(torch.from_numpy(scores),
                                 torch.from_numpy(l1), beta, threshold)
    want = jref.brsgd_select_mask(jnp.asarray(scores), jnp.asarray(l1),
                                  beta, threshold)
    for g, w in zip(got, want):
        exact(g, w)
    kth, T = tref.brsgd_thresholds(torch.from_numpy(scores),
                                   torch.from_numpy(l1), beta, threshold)
    jk, jT = jref.brsgd_thresholds(jnp.asarray(scores), jnp.asarray(l1),
                                   beta, threshold)
    assert float(kth) == float(jk) and float(T) == float(jT)


def test_empty_intersection_falls_back_to_c2():
    scores = torch.tensor([5.0, 5.0, 1.0, 1.0])
    l1 = torch.tensor([100.0, 100.0, 1.0, 1.0])
    sel, c1, c2, _ = tref.brsgd_select_mask(scores, l1, 0.5, 1.0)
    assert not bool((c1 & c2).any())
    exact(sel, c2)
