"""The port's kernel modules: dispatch (repro_torch.kernels.ops), the
CUDA wrappers' guards and build, and parity with the JAX package's
Pallas kernels in interpret mode on the same numpy inputs.

Tolerances: scores, selection weights and medians exact; l1 and the
means within 1e-5 of the largest finite reference magnitude.  NaN must
sit where the reference has it.  The CUDA kernels
themselves are held against their plain versions in test_torch_gpu.py.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.brsgd_stats import (brsgd_partials_pallas,
                                       brsgd_stats_pallas,
                                       cwise_median_pallas,
                                       masked_mean_pallas,
                                       select_mean_pallas)
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import brsgd_stats as kern

RTOL = 1e-5


def close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    finite = np.abs(want[np.isfinite(want)])
    scale = max(finite.max(initial=0.0), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def mat(m, d, seed=0):
    return np.random.default_rng(seed).normal(size=(m, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# CPU: dispatch and parity with the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [5, 8, 20])
def test_brsgd_stats_matches_pallas(m):
    G = mat(m, 203, seed=m)
    got = ops.brsgd_stats(torch.from_numpy(G))
    want = brsgd_stats_pallas(jnp.asarray(G), d_blk=64)
    exact(got[0], want[0])                                    # median
    close(got[1], want[1])                                    # mean
    exact(got[2], want[2])                                    # scores
    close(got[3], want[3])                                    # l1
    exact(ops.cwise_median(torch.from_numpy(G)),
          cwise_median_pallas(jnp.asarray(G), d_blk=64))


def test_brsgd_partials_matches_pallas():
    G = mat(20, 203, seed=1)
    sc, l1 = ops.brsgd_partials(torch.from_numpy(G))
    want_sc, want_l1 = brsgd_partials_pallas(jnp.asarray(G), d_blk=64)
    exact(sc, want_sc)
    close(l1, want_l1)


@pytest.mark.parametrize("beta,threshold", [(0.5, 0.0), (0.25, 0.0),
                                            (0.5, 1e-6)])
def test_select_mean_matches_pallas(beta, threshold):
    """threshold=1e-6 empties C1, so both take the C2 fallback."""
    G = mat(8, 203, seed=2)
    G[:2] *= 50.0                                             # outliers
    Gt = torch.from_numpy(G)
    sc, l1 = ops.brsgd_partials(Gt)
    kth, T = ref.brsgd_thresholds(sc, l1, beta, threshold)
    agg, w = ops.brsgd_select_mean(Gt, sc, l1, kth, T)
    want_agg, want_w = select_mean_pallas(
        jnp.asarray(G), jnp.asarray(sc.numpy()), jnp.asarray(l1.numpy()),
        beta, threshold, d_blk=64)
    exact(w, want_w)
    close(agg, want_agg)


@pytest.mark.parametrize("kind", ["bool", "weights", "empty"])
def test_masked_mean_matches_pallas(kind):
    G = mat(7, 203, seed=3)
    rng = np.random.default_rng(4)
    mask = {"bool": rng.random(7) < 0.5,
            "weights": rng.random(7).astype(np.float32),
            "empty": np.zeros(7, bool)}[kind]
    got = ops.masked_mean(torch.from_numpy(G), torch.from_numpy(mask))
    close(got, masked_mean_pallas(jnp.asarray(G), jnp.asarray(mask),
                                  d_blk=64))
    if kind == "empty":
        exact(got, np.zeros(203, np.float32))


def test_cpu_dispatch_is_the_plain_version():
    Gt = torch.from_numpy(mat(8, 50, seed=5))
    for needs in (("scores", "l1"), ("gram",), ("d2med", "l1")):
        got, want = ops.fused_stats(Gt, needs), ref.fused_stats_ref(Gt, needs)
        for n in needs:
            exact(got[n], want[n])
    assert ops.fused_stats(Gt, ()) == {}
    mask = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.bool)
    exact(ops.masked_mean(Gt, mask), ref.masked_mean_det(Gt, mask))
    for a, b in zip(ops.brsgd_stats(Gt), ref.brsgd_stats_ref(Gt)):
        exact(a, b)


@pytest.mark.parametrize("where", ["row", "scattered"])
def test_nan_worker_matches_pallas(where):
    """A worker whose gradient holds NaN (a whole row, or every 5th
    column): the bitonic sort propagates NaN, so the medians, l1 and
    selection of the plain versions follow the Pallas kernels'."""
    G = mat(7, 203, seed=8)
    if where == "row":
        G[3] = np.nan
    else:
        G[3, ::5] = np.nan
    Gt = torch.from_numpy(G)
    got = ops.brsgd_stats(Gt)
    want = brsgd_stats_pallas(jnp.asarray(G), d_blk=64)
    exact(got[0], want[0])                                    # median
    close(got[1], want[1])                                    # mean
    exact(got[2], want[2])                                    # scores
    close(got[3], want[3])                                    # l1
    sc, l1 = ops.brsgd_partials(Gt)
    want_sc, want_l1 = brsgd_partials_pallas(jnp.asarray(G), d_blk=64)
    exact(sc, want_sc)
    close(l1, want_l1)
    # scores are held against the Pallas kernel above: the JAX jnp
    # fused_stats_ref counts the minority side as g < mean, which a NaN
    # mean makes empty, where the Pallas kernels take ~(g >= mean)
    needs = ("l1", "d2med", "gram")
    got = ops.fused_stats(Gt, needs)
    want = jref.fused_stats_ref(jnp.asarray(G), needs)
    for n in needs:
        close(got[n], want[n])
    kth, T = ref.brsgd_thresholds(sc, l1, 0.5, 0.0)
    agg, w = ops.brsgd_select_mean(Gt, sc, l1, kth, T)
    want_agg, want_w = select_mean_pallas(
        jnp.asarray(G), jnp.asarray(sc.numpy()), jnp.asarray(l1.numpy()),
        0.5, 0.0, d_blk=64)
    exact(w, want_w)
    # every row is summed, weight 0 included, as the Pallas matvec and
    # the JAX c + w·g do: a dropped NaN row makes its columns NaN
    exact(agg, jref.masked_mean_det(jnp.asarray(G), jnp.asarray(w.numpy())))
    exact(np.isnan(agg.numpy()), np.isnan(np.asarray(want_agg)))
    mask = np.arange(7) != 3
    got = ops.masked_mean(Gt, torch.from_numpy(mask))
    exact(got, jref.masked_mean_det(jnp.asarray(G), jnp.asarray(mask)))
    exact(np.isnan(got.numpy()), np.isnan(G[3]))


def test_wrappers_refuse_cpu_tensors_and_count_nothing():
    G = torch.from_numpy(mat(8, 50))
    kern.reset_launches()
    calls = [lambda: kern.fused_stats(G, ("scores",)),
             lambda: kern.brsgd_partials(G),
             lambda: kern.select_mean(G, torch.zeros(8), torch.zeros(8),
                                      torch.tensor(0.0), torch.tensor(1.0)),
             lambda: kern.masked_mean(G, torch.ones(8)),
             lambda: kern.brsgd_stats(G),
             lambda: kern.cwise_median(G),
             lambda: kern.trimmed_mean(G, 0.1)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert set(kern.LAUNCHES.values()) == {0}


def test_supported_worker_counts_match_the_cuda_source():
    """The tuned instances are brsgd_stats.cu's cases; every other m in
    1..64 takes the bucket of its power of two in brsgd_bucket.cu."""
    src = _build.SOURCE.read_text()
    cases = tuple(int(c) for c in re.findall(r"case (\d+): \{ constexpr int M",
                                             src))
    assert cases == kern.TUNED_M
    bucket_src = _build.SOURCES["brsgd_bucket"].read_text()
    buckets = tuple(int(c) for c in re.findall(r"BRSGD_BUCKET\((\d+), CALL\)",
                                               bucket_src))
    assert buckets == kern.BUCKETS
    assert "(m) > 64" in bucket_src and kern.MAX_M == 64
    for m in range(1, kern.MAX_M + 1):
        rows = kern.instance_rows(m)
        if m in kern.TUNED_M:
            assert rows == m
        else:
            assert rows in kern.BUCKETS and (rows // 2 < m <= rows or m == 1)
    assert kern.instance_rows(1) == 2


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_output_is_keyed_by_source_and_ignored():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert re.fullmatch(r"brsgd_stats-[0-9a-f]{12}\.so", path.name)
    root = _build.BUILD_DIR.parents[1]
    ignored = (root / ".gitignore").read_text().split()
    assert "build/" in ignored
