"""The fused brsgd aggregation (``ops.brsgd_aggregate``): its plain
version and the CPU dispatch against the JAX package's fast path
(``brsgd_partials_pallas`` -> ``select_mean_pallas`` in interpret mode,
and ``engine.brsgd_select``) on the same numpy inputs, and the fused
kernel's host-side launch plan, which needs no card.

Tolerances: scores, kth, the masks and the weights exact; l1, the auto
𝔗 and the aggregate within 1e-5 of the largest finite reference
magnitude (the JAX partials are summed per 64-column block and combined
by a matvec).  The kernel itself is held against the plain version in
test_torch_gpu.py.
"""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.kernels import ref as jref
from repro.kernels.brsgd_stats import brsgd_partials_pallas, select_mean_pallas
from repro_torch.configs.base import ByzantineConfig
from repro_torch.core import engine as teng
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import brsgd_stats as kern

RTOL = 1e-5
D = 203                     # ragged against the 64-column Pallas blocks


def close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    finite = np.abs(want[np.isfinite(want)])
    scale = max(finite.max(initial=0.0), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def attacked(m, seed=0):
    """Honest rows of scale 2e-3 (l1 to the median ~0.3) and a quarter
    of the rows scaled by 50: threshold 0.5 keeps exactly the honest
    rows in C1, 1e-6 keeps none (the C2 fallback)."""
    rng = np.random.default_rng(seed)
    G = (2e-3 * rng.normal(size=(m, D))).astype(np.float32)
    G[:max(1, m // 4)] *= np.float32(50.0)
    return G


@functools.lru_cache(maxsize=None)
def jax_partials(m):
    G = attacked(m, seed=m)
    sc, l1 = brsgd_partials_pallas(jnp.asarray(G), d_blk=64)
    return G, sc, l1


@pytest.mark.parametrize("m", [5, 7, 20, 64])
@pytest.mark.parametrize("beta", [0.25, 0.5])
@pytest.mark.parametrize("threshold", [0.0, 1e-6, 0.5])
def test_brsgd_aggregate_matches_jax_fast_path(m, beta, threshold):
    G, sc_j, l1_j = jax_partials(m)
    Gt = torch.from_numpy(G)
    r = ref.brsgd_aggregate_plain(Gt, beta, threshold)
    agg_j, w_j = select_mean_pallas(jnp.asarray(G), sc_j, l1_j, beta,
                                    threshold, d_blk=64)
    st_j = jeng.brsgd_select(sc_j, l1_j, beta, threshold)
    exact(r.scores, sc_j)
    close(r.l1, l1_j)
    exact(r.w, w_j)
    exact(r.selected, st_j.selected)
    exact(r.c1, st_j.c1)
    exact(r.c2, st_j.c2)
    exact(r.kth, jref.rank_select(sc_j, ref.brsgd_rank_indices(m, beta)[0]))
    (exact if threshold > 0 else close)(r.threshold, st_j.threshold)
    close(r.agg, agg_j)
    assert r.agg.shape == (D,) and r.w.dtype == torch.float32
    assert r.selected.dtype == torch.bool
    if threshold == 1e-6:                       # C1 empty: the C2 fallback
        assert not r.c1.any() and torch.equal(r.selected, r.c2)
    if threshold == 0.5:                        # C1 is the honest rows
        exact(r.c1, np.arange(m) >= max(1, m // 4))
    # the CPU dispatch and the engine take this plain version
    o = ops.brsgd_aggregate(Gt, beta, threshold)
    for a, b in zip(o, r):
        exact(a, b)
    cfg = ByzantineConfig(aggregator="brsgd", beta=beta, threshold=threshold)
    agg, st = teng.aggregate_local(Gt, cfg, return_state=True)
    exact(agg, r.agg)
    for got, want in zip(st, (r.selected, r.c1, r.c2, r.scores, r.l1,
                              r.threshold)):
        exact(got, want)


@pytest.mark.parametrize("m", [7, 20])
@pytest.mark.parametrize("where", ["row", "scattered"])
def test_brsgd_aggregate_with_a_nan_worker(m, where):
    """A worker whose gradient holds NaN: scores and weights follow the
    Pallas kernels; the aggregate sums every row, weight 0 included, as
    the JAX package's c + w·g and w @ g do, so a dropped NaN row makes
    its columns NaN: it is the JAX row-order mean over all rows, with NaN
    where the Pallas fast path has it."""
    G = attacked(m, seed=30 + m)
    if where == "row":
        G[2] = np.nan
    else:
        G[2, ::5] = np.nan
    r = ops.brsgd_aggregate(torch.from_numpy(G), 0.5, 0.0)
    sc_j, l1_j = brsgd_partials_pallas(jnp.asarray(G), d_blk=64)
    _, w_j = select_mean_pallas(jnp.asarray(G), sc_j, l1_j, 0.5, 0.0,
                                d_blk=64)
    st_j = jeng.brsgd_select(sc_j, l1_j, 0.5, 0.0)
    exact(r.scores, sc_j)
    close(r.l1, l1_j)
    exact(r.w, w_j)
    for got, want in ((r.selected, st_j.selected), (r.c1, st_j.c1),
                      (r.c2, st_j.c2)):
        exact(got, want)
    if where == "row":              # every l1 is NaN: no rank hits, 𝔗 = -inf
        assert float(r.threshold) == -np.inf and not r.c1.any()
    exact(r.agg, jref.masked_mean_det(jnp.asarray(G),
                                      jnp.asarray(r.w.numpy())))
    agg_j, _ = select_mean_pallas(jnp.asarray(G), sc_j, l1_j, 0.5, 0.0,
                                  d_blk=64)
    exact(np.isnan(r.agg.numpy()), np.isnan(np.asarray(agg_j)))


def test_brsgd_aggregate_equals_the_two_pass_composition():
    """The plain version keeps the bits of the composition the engine ran
    before the fused launch: B1's call, the thresholds, B2, the masks."""
    Gt = torch.from_numpy(attacked(20, seed=4))
    for beta, threshold in ((0.5, 0.0), (0.25, 0.5)):
        sc, l1 = ops.brsgd_partials(Gt)
        kth, T = ref.brsgd_thresholds(sc, l1, beta, threshold)
        agg, w = ops.brsgd_select_mean(Gt, sc, l1, kth, T)
        _, c1, c2 = ref.brsgd_masks(sc, l1, kth, T)
        r = ops.brsgd_aggregate(Gt, beta, threshold)
        for got, want in zip(r, (agg, w, w > 0, c1, c2, sc, l1, kth, T)):
            exact(got, want)


@pytest.mark.parametrize("m,beta", [(20, 0.5), (20, 0.25), (7, 0.5),
                                    (5, 1.0), (64, 0.1)])
def test_rank_indices_match_the_thresholds(m, beta):
    k_idx, q_idx = ref.brsgd_rank_indices(m, beta)
    assert k_idx == m - max(1, int(np.ceil(beta * m)))
    assert q_idx == jref.quantile_nearest_index(0.25, m)
    x = torch.from_numpy(np.random.default_rng(m).permutation(m)
                         .astype(np.float32))
    kth, T = ref.brsgd_thresholds(x, x, beta, 0.0)
    assert float(kth) == k_idx and float(T) == q_idx


# ---------------------------------------------------------------------------
# the fused kernel's launch plan (pure Python: no card)
# ---------------------------------------------------------------------------

H100_BLOCKS = 132 * 8


def blocks(n):
    """A card that holds n blocks at once, whatever their shared memory."""
    return lambda smem: n


def h100_blocks(smem):
    """Co-resident blocks of a card like the H100 as a function of each
    block's dynamic shared memory: 132 SMs of 228 KB, 1 KB of it kept by
    the system per block, at most 8 blocks an SM."""
    return 132 * min(8, 233472 // (smem + kern.AGG_STATIC_SMEM + 1024))


def test_plan_keeps_the_paper_shape_resident():
    """[20, 61706]: 483 tiles on 483 blocks of one tile each, 10 KB of
    shared memory a block; G is 4.9 MB, pass 2 never reads it again."""
    plan = kern.aggregate_plan(20, 61706, blocks(H100_BLOCKS))
    assert plan == kern.AggregatePlan(483, True, 20 * 128 * 4)


@pytest.mark.parametrize("d,occ", [(8_388_608, blocks(H100_BLOCKS)),
                                   (8_388_608, h100_blocks),
                                   (2_000_003, h100_blocks)])
def test_plan_streams_hbm_shapes_twice(d, occ):
    """G far beyond the card's shared memory: every co-resident block, G
    re-read in pass 2, no shared memory asked at m = 20.  (At 2,000,003
    columns 15 tiles of 10 KB a block would fit, but not with 1,042
    blocks co-resident.)"""
    plan = kern.aggregate_plan(20, d, occ)
    assert plan == kern.AggregatePlan(H100_BLOCKS, False, 0)


@pytest.mark.parametrize("m", kern.TUNED_M)
def test_plan_never_asks_more_shared_memory_than_a_block_has(m):
    limit = kern.SMEM_BLOCK_LIMIT - kern.AGG_STATIC_SMEM
    for d in (1, 20, 127, 1003, 4096, 61706, 2 ** 20, 2_000_003,
              8_388_608):
        for occ in (blocks(H100_BLOCKS), blocks(132), h100_blocks):
            plan = kern.aggregate_plan(m, d, occ)
            n_tiles = -(-d // kern.THREADS)
            assert 1 <= plan.grid <= min(n_tiles, occ(plan.smem))
            assert plan.smem <= limit
            assert plan.smem == kern.aggregate_smem(m, d, plan.grid,
                                                    plan.resident)
            sort = 4 * 64 * kern.THREADS if m == 64 else 0
            slots = -(-n_tiles // plan.grid) if plan.resident else 0
            assert plan.smem == sort + 4 * m * kern.THREADS * slots


def test_plan_fits_a_block_at_every_worker_count():
    """Every m in 1..64 (tuned or bucket): the brsgd launch's grid is
    co-resident, its shared memory within a block, its slots [m, THREADS]
    after the 64-row sort columns of m > 32."""
    limit = kern.SMEM_BLOCK_LIMIT - kern.AGG_STATIC_SMEM
    for m in range(1, kern.MAX_M + 1):
        assert kern.gram_pairs(m, "brsgd") == 2 * m
        for d in (61, 1003, 61706, 2_000_003):
            plan = kern.aggregate_plan(m, d, h100_blocks)
            n_tiles = -(-d // kern.THREADS)
            assert 1 <= plan.grid <= min(n_tiles, h100_blocks(plan.smem))
            assert plan.smem <= limit
            sort = 4 * 64 * kern.THREADS if m > 32 else 0
            slots = -(-n_tiles // plan.grid) if plan.resident else 0
            assert plan.smem == sort + 4 * m * kern.THREADS * slots


def test_plan_takes_more_tiles_per_block_when_blocks_run_out():
    """Fewer co-resident blocks than tiles: the fewest tiles per block
    that fit, and the grid that number needs."""
    plan = kern.aggregate_plan(20, 61706, blocks(132))
    assert plan == kern.AggregatePlan(121, True, 4 * 20 * 128 * 4)
    # a card that holds fewer blocks as each asks for more shared memory:
    # 1 and 2 tiles a block need more blocks than it holds, 4 do not
    plan = kern.aggregate_plan(
        20, 61706, lambda s: 132 * (3 if s <= 10240 else 1))
    assert plan == kern.AggregatePlan(121, True, 4 * 20 * 128 * 4)
    assert kern.aggregate_plan(20, 61706, h100_blocks) == \
        kern.AggregatePlan(483, True, 10240)
    with pytest.raises(RuntimeError, match="no block"):
        kern.aggregate_plan(20, 61706, blocks(0))


def test_plan_constants_match_the_cuda_source():
    src = _build.expanded_source()
    for name in ("THREADS", "SMEM_SORT_M", "SMEM_BLOCK_LIMIT",
                 "AGG_STATIC_SMEM"):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == getattr(kern, name), name
    assert "cudaLaunchCooperativeKernel" in src
    sig = _build.SIGNATURES["brsgd_stats"]
    assert len(sig["brsgd_select_aggregate"]) == 13
    assert sig["brsgd_select_aggregate"][6] is _build.ctypes.c_float
    assert "brsgd_aggregate" not in sig


def test_fused_wrapper_refuses_cpu_tensors_and_counts_nothing():
    kern.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kern.brsgd_aggregate(torch.zeros(20, 50), 0.5, 0.0)
    assert kern.LAUNCHES["brsgd_aggregate"] == 0
