"""The fused select rules (``ops.select_aggregate``): krum, multi_krum and
geomedian, each one launch on the card, and the mean (B3 alone).  Their
plain composition (``ref.select_aggregate_plain``) and the CPU dispatch
are held against the JAX package's path on the same numpy inputs —
``fused_stats_pallas(G, ("gram", ...))`` in interpret mode, then
``engine._krum_select`` / ``_multi_krum_select`` / ``_geomedian_select``,
then ``masked_mean_pallas`` — at every supported worker count, a ragged
d, a NaN worker, duplicate rows and bound n_select / iters / eps; and
the fused kernel's launch plan is pinned without a card.

Tolerances: krum and multi_krum weights and selections exact; their
scores within 1e-5 of the largest finite score (the Pallas gram sums
64-column blocks, torch one product, so gram differs in its last bits);
geomedian's weights within 1e-5 of the largest weight (the registry's
GEOMEDIAN_RTOL: its Weiszfeld matvecs sum in another order); every
aggregate within 1e-5 of its largest magnitude against the Pallas
matvec, and bit-equal to ``masked_mean_det`` of the plain weights.  The
kernel itself is held against the plain version in test_torch_gpu.py.
"""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ByzantineConfig as JCfg
from repro.core import engine as jeng
from repro.kernels import ref as jref
from repro.kernels.brsgd_stats import fused_stats_pallas, masked_mean_pallas
from repro_torch.configs.base import ByzantineConfig as TCfg
from repro_torch.core import engine as teng
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import brsgd_stats as kern

RTOL = 1e-5
D = 203                     # ragged against the 64-column Pallas blocks
RULES = ("krum", "multi_krum", "geomedian")
NEEDS = {"krum": ("gram",), "multi_krum": ("gram",),
         "geomedian": ("d2med", "gram")}


def close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.abs(want[np.isfinite(want)])
    scale = max(finite.max(initial=0.0), 1e-30)
    keep = ~np.isnan(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=0,
                               atol=rtol * scale)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def workers(m, seed=0):
    """Honest rows around a shared gradient, a quarter of them scaled by
    -4 (outlying, but on the honest rows' scale, so the scores of both
    matter to a relative tolerance)."""
    rng = np.random.default_rng(seed)
    G = (rng.normal(size=D) + 0.5 * rng.normal(size=(m, D))).astype(
        np.float32)
    G[:max(1, m // 4)] *= np.float32(-4.0)
    return G


def host_args(rule, m, cfg, n_select=0, iters=teng.GEOMEDIAN_ITERS,
              eps=teng.GEOMEDIAN_EPS):
    f = teng._krum_f(cfg, m)
    if rule == "geomedian":
        return {"iters": iters, "eps": eps}
    args = {"n_close": max(1, m - f - 2)}
    if rule == "multi_krum":
        args["k"] = min(m, n_select or max(1, m - f))
    return args


def jax_path(G, rule, cfg, stats=None, **kw):
    """The JAX package's local composition: the Pallas stats pass in
    interpret mode (``stats``, when given, is its output for G), the
    engine's rule, the Pallas masked mean."""
    m = G.shape[0]
    if stats is None:
        stats = fused_stats_pallas(jnp.asarray(G), NEEDS[rule], d_blk=64)
    select = {"krum": jeng._krum_select, "multi_krum": jeng._multi_krum_select,
              "geomedian": jeng._geomedian_select}[rule]
    w, _ = select(stats, cfg, m, **kw)
    scores = (None if rule == "geomedian"
              else jeng._krum_scores(stats["gram"], cfg, m))
    return (masked_mean_pallas(jnp.asarray(G), w, d_blk=64), np.asarray(w),
            scores, stats)


@functools.lru_cache(maxsize=None)
def jax_stats(m):
    """G [m, D] and its Pallas (d2med, gram), which every rule reads."""
    G = workers(m, seed=m)
    return G, fused_stats_pallas(jnp.asarray(G), ("d2med", "gram"), d_blk=64)


def jax_case(m, rule):
    G, stats = jax_stats(m)
    return G, jax_path(G, rule, JCfg(alpha=0.25), stats)


def check_against_jax(G, rule, r, agg_j, w_j, scores_j, stats_j):
    if rule == "geomedian":
        close(r.w, w_j)
        close(r.d2med, stats_j["d2med"])
        assert r.scores is None
    else:
        exact(r.w, w_j)
        close(r.scores, scores_j)
        assert r.d2med is None
    close(r.gram, stats_j["gram"])
    exact(r.selected, np.asarray(r.w) > 0)
    close(r.agg, agg_j)
    exact(r.agg, ref.masked_mean_det(torch.from_numpy(G), r.w))


@pytest.mark.parametrize("m", kern.TUNED_M)
@pytest.mark.parametrize("rule", RULES)
def test_select_aggregate_matches_jax_path(m, rule):
    G, (agg_j, w_j, scores_j, stats_j) = jax_case(m, rule)
    Gt = torch.from_numpy(G)
    args = host_args(rule, m, TCfg(alpha=0.25))
    r = ref.select_aggregate_plain(Gt, rule, **args)
    check_against_jax(G, rule, r, agg_j, w_j, scores_j, stats_j)
    assert r.agg.shape == (D,) and r.w.dtype == torch.float32
    assert r.selected.dtype == torch.bool and r.gram.shape == (m, m)
    if rule != "geomedian":
        assert int(r.selected.sum()) == (1 if rule == "krum" else args["k"])
    # the CPU dispatch and the engine take this plain version
    for a, b in zip(ops.select_aggregate(Gt, rule, **args), r):
        if b is None:
            assert a is None
        else:
            exact(a, b)
    cfg = TCfg(aggregator=rule, alpha=0.25)
    agg, st = teng.aggregate_local(Gt, cfg, return_state=True)
    exact(agg, r.agg)
    exact(st.selected, r.selected)
    exact(st.weights, r.w)


@pytest.mark.parametrize("rule", RULES)
def test_plain_composition_keeps_the_eager_engine_bits(rule):
    """The plain composition equals, bit for bit, the eager path the
    engine ran before the fused launch: the spec's statistics, its select
    rule, and the row-order combine."""
    Gt = torch.from_numpy(workers(20, seed=3))
    cfg = TCfg(aggregator=rule, alpha=0.25)
    spec = teng.get_spec(rule)
    w, _ = spec.select(ref.fused_stats_ref(Gt, spec.stats), cfg, 20)
    r = ops.select_aggregate(Gt, rule, **host_args(rule, 20, cfg))
    exact(r.w, w)
    exact(r.agg, ref.masked_mean_det(Gt, w))


def test_mean_is_the_row_order_mean():
    Gt = torch.from_numpy(workers(20, seed=4))
    r = ops.select_aggregate(Gt, "mean")
    exact(r.agg, ref.column_mean_ref(Gt))
    exact(r.w, np.ones(20, np.float32))
    assert bool(r.selected.all())
    assert (r.scores, r.gram, r.d2med) == (None, None, None)
    agg, st = teng.aggregate_local(Gt, TCfg(aggregator="mean"), True)
    exact(agg, r.agg)
    exact(st.weights, r.w)
    close(agg, masked_mean_pallas(jnp.asarray(Gt.numpy()),
                                  jnp.ones(20, bool), d_blk=64))


@pytest.mark.parametrize("m", [7, 20])
@pytest.mark.parametrize("where", ["row", "scattered"])
@pytest.mark.parametrize("rule", RULES)
def test_select_aggregate_with_a_nan_worker(m, where, rule):
    """A worker whose gradient holds NaN has a NaN gram row and column.
    krum: its score is NaN and argmin returns the first NaN, so it is the
    one selected (as jnp.argmin); multi_krum ranks it last; geomedian's
    d2med (every column with a NaN has a NaN median) makes every weight
    NaN.  The aggregate sums every row, weight 0 included (the JAX
    package's c + w·g and w @ g), so it is the JAX row-order mean over all
    rows: NaN wherever the NaN worker's row is, selected or not."""
    G = workers(m, seed=50 + m)
    if where == "row":
        G[2] = np.nan
    else:
        G[2, ::5] = np.nan
    cfg = JCfg(alpha=0.25)
    _, w_j, scores_j, stats_j = jax_path(G, rule, cfg)
    r = ops.select_aggregate(torch.from_numpy(G), rule,
                             **host_args(rule, m, TCfg(alpha=0.25)))
    if rule == "geomedian":
        assert np.isnan(w_j).all()
        close(r.w, w_j)
        assert np.isnan(np.asarray(r.agg)).all()
        return
    exact(r.w, w_j)
    close(r.scores, scores_j)
    assert np.isnan(np.asarray(r.scores)[2])
    assert bool(r.selected[2]) == (rule == "krum")
    exact(r.agg, jref.masked_mean_det(jnp.asarray(G),
                                      jnp.asarray(np.asarray(r.w))))
    exact(np.isnan(np.asarray(r.agg)), np.isnan(G[2]))


@pytest.mark.parametrize("m", [8, 20])
@pytest.mark.parametrize("rule", ["krum", "multi_krum"])
def test_duplicate_rows_tie_and_break_by_worker_index(m, rule):
    """Duplicated workers have bit-equal scores; argmin and the stable
    argsort keep the lower index, as in the JAX package."""
    G = workers(m, seed=70 + m)
    G[m - 1] = G[m // 2]
    G[m - 2] = G[m // 2]
    _, w_j, scores_j, _ = jax_path(G, rule, JCfg(alpha=0.25))
    r = ops.select_aggregate(torch.from_numpy(G), rule,
                             **host_args(rule, m, TCfg(alpha=0.25)))
    s = np.asarray(r.scores)
    assert s[m - 1] == s[m // 2] == s[m - 2]
    exact(r.w, w_j)
    close(r.scores, scores_j)


def test_bound_n_select_iters_and_eps_reach_the_launch():
    """spec_with's bound keywords, read from ``spec.select``, reach
    ops.select_aggregate, which agrees with the JAX rule called with
    them."""
    G, stats = jax_stats(20)
    Gt = torch.from_numpy(G)
    cfg = TCfg(alpha=0.25)
    for n in (1, 3, 20):
        spec = teng.spec_with("multi_krum", n_select=n)
        assert teng.rule_args(spec, cfg, 20) == {"n_close": 13, "k": n}
        agg, st = teng.aggregate_local(Gt, cfg, True, spec=spec)
        agg_j, w_j, _, _ = jax_path(G, "multi_krum", JCfg(alpha=0.25),
                                    stats, n_select=n)
        exact(st.weights, w_j)
        assert int(st.selected.sum()) == n
        close(agg, agg_j)
    for iters, eps in ((1, 1e-6), (4, 1e-3), (4, 10.0)):
        spec = teng.spec_with("geomedian", iters=iters, eps=eps)
        assert teng.rule_args(spec, cfg, 20) == {"iters": iters, "eps": eps}
        agg, st = teng.aggregate_local(Gt, cfg, True, spec=spec)
        agg_j, w_j, _, _ = jax_path(G, "geomedian", JCfg(alpha=0.25),
                                    stats, iters=iters, eps=eps)
        close(st.weights, w_j)
        close(agg, agg_j)
        exact(agg, ops.select_aggregate(Gt, "geomedian", iters=iters,
                                        eps=eps).agg)
    assert teng.rule_args(teng.get_spec("krum"), cfg, 20) == {"n_close": 13}
    assert teng.rule_args(teng.get_spec("mean"), cfg, 20) == {}


def test_unknown_rules_are_refused():
    with pytest.raises(ValueError, match="unknown select rule"):
        ref.select_aggregate_plain(torch.zeros(4, 8), "median")
    # a fixed round of a select rule with no fused launch is refused, not
    # run eagerly
    custom = teng.AggregatorSpec("custom", stats=frozenset({"gram"}),
                                 select=teng.get_spec("krum").select)
    with pytest.raises(ValueError, match="unknown select rule"):
        teng.aggregate_local(torch.zeros(4, 8), TCfg(), spec=custom)
    with pytest.raises(ValueError, match="no fused launch"):
        kern.gram_pairs(20, "mean")


# ---------------------------------------------------------------------------
# the fused kernel's launch plan (pure Python: no card)
# ---------------------------------------------------------------------------

H100_BLOCKS = 132 * 8


def blocks(n):
    """A card that holds n blocks at once, whatever their shared memory."""
    return lambda smem: n


def h100_blocks(smem):
    """Co-resident blocks of a card like the H100: 132 SMs of 228 KB, 1 KB
    kept by the system per block, at most 8 blocks an SM."""
    return 132 * min(8, 233472 // (smem + kern.AGG_STATIC_SMEM + 1024))


def test_gram_pairs_count_the_upper_triangle():
    assert kern.gram_pairs(20, "brsgd") == 40
    assert kern.gram_pairs(20, "krum") == kern.gram_pairs(20, "multi_krum") \
        == 210
    assert kern.gram_pairs(64, "geomedian") == 64 * 65 // 2 + 64


@pytest.mark.parametrize("rule,smem", [("krum", 4 * (2 * 20 * 21 + 20 * 132)),
                                       ("geomedian",
                                        4 * (480 + 20 * 132))])
def test_plan_keeps_the_paper_shape_resident(rule, smem):
    """[20, 61706]: 483 tiles on 483 blocks of one tile each; the slot is
    20 rows of GRAM_LD = 132 floats, after the rule's scratch (krum two
    [20, 21] matrices; geomedian one and 3 x 20 floats)."""
    assert kern.aggregate_plan(20, 61706, blocks(H100_BLOCKS), rule) == \
        kern.AggregatePlan(483, True, smem)
    assert kern.aggregate_plan(20, 61706, h100_blocks, rule) == \
        kern.AggregatePlan(483, True, smem)


@pytest.mark.parametrize("rule", RULES)
def test_plan_streams_the_hbm_shape_through_one_staging_slot(rule):
    plan = kern.aggregate_plan(20, 8_388_608, h100_blocks, rule)
    assert not plan.resident and plan.grid == H100_BLOCKS
    assert plan.smem == kern.aggregate_smem(20, 8_388_608, plan.grid, False,
                                            rule)
    scratch = 2 * 20 * 21 if rule != "geomedian" else 480
    assert plan.smem == 4 * (scratch + 20 * kern.GRAM_LD)


@pytest.mark.parametrize("m", kern.TUNED_M)
@pytest.mark.parametrize("rule", RULES)
def test_plan_never_asks_more_shared_memory_than_a_block_has(m, rule):
    limit = kern.SMEM_BLOCK_LIMIT - kern.AGG_STATIC_SMEM
    rows = -(-m // kern.GRAM_RB) * kern.GRAM_RB
    for d in (1, 20, 127, 1003, 4096, 61706, 2_000_003, 8_388_608):
        for occ in (blocks(H100_BLOCKS), blocks(132), h100_blocks):
            plan = kern.aggregate_plan(m, d, occ, rule)
            n_tiles = -(-d // kern.THREADS)
            assert 1 <= plan.grid <= min(n_tiles, occ(plan.smem))
            assert plan.smem <= limit
            sort = 4 * 64 * kern.THREADS if (m == 64 and
                                             rule == "geomedian") else 0
            slots = -(-n_tiles // plan.grid) if plan.resident else 1
            fixed = kern.aggregate_smem(m, d, plan.grid, False, rule) - \
                4 * rows * kern.GRAM_LD
            assert fixed >= sort
            assert plan.smem == fixed + 4 * rows * kern.GRAM_LD * slots


def test_gram_plans_fit_a_block_at_every_worker_count():
    """Every m in 1..64 (tuned or bucket) and gram rule: a co-resident
    grid within a block's shared memory; slots of m rows rounded up to
    GRAM_RB after the rule's [m]-sized scratch and, for geomedian's
    median at m > 32, the 64-row sort columns; m(m+1)/2 partial sums
    (+ m for geomedian)."""
    limit = kern.SMEM_BLOCK_LIMIT - kern.AGG_STATIC_SMEM
    for m in range(1, kern.MAX_M + 1):
        rows = -(-m // kern.GRAM_RB) * kern.GRAM_RB
        for rule in RULES:
            geo = rule == "geomedian"
            assert kern.gram_pairs(m, rule) == m * (m + 1) // 2 + geo * m
            scratch = (-(-(m * (m + 1) + 3 * m) // 4) * 4 if geo
                       else 2 * m * (m + 1))
            sort = 64 * kern.THREADS if geo and m > 32 else 0
            for d in (61, 1003, 61706, 2_000_003):
                plan = kern.aggregate_plan(m, d, h100_blocks, rule)
                n_tiles = -(-d // kern.THREADS)
                assert 1 <= plan.grid <= min(n_tiles, h100_blocks(plan.smem))
                assert plan.smem <= limit
                slots = -(-n_tiles // plan.grid) if plan.resident else 1
                assert plan.smem == 4 * (sort + scratch
                                         + slots * rows * kern.GRAM_LD)


def test_brsgd_plan_is_unchanged_by_the_rule_argument():
    for d in (20, 61706, 2_000_003, 8_388_608):
        assert kern.aggregate_plan(20, d, h100_blocks) == \
            kern.aggregate_plan(20, d, h100_blocks, "brsgd")
    assert kern.aggregate_smem(20, 61706, 483, True) == 20 * 128 * 4


def test_constants_match_the_cuda_source():
    src = _build.expanded_source()
    assert re.search(r"constexpr int GRAM_RB = (\d+);", src).group(1) == \
        str(kern.GRAM_RB)
    assert "constexpr int GRAM_LD = THREADS + 4;" in src
    assert kern.GRAM_LD == kern.THREADS + 4
    for rule, name in (("brsgd", "RULE_BRSGD"), ("krum", "RULE_KRUM"),
                       ("geomedian", "RULE_GEOMEDIAN")):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == kern.RULE_IDS[rule]
    assert kern.RULE_IDS["multi_krum"] == kern.RULE_IDS["krum"]
    sig = _build.SIGNATURES["brsgd_stats"]
    assert len(sig["brsgd_select_aggregate"]) == 13
    assert sig["brsgd_select_aggregate"][6] is _build.ctypes.c_float
    assert len(sig["brsgd_masked_mean"]) == 8


def test_fused_wrapper_refuses_cpu_tensors_and_counts_nothing():
    kern.reset_launches()
    for rule in ("mean",) + RULES:
        with pytest.raises(ValueError, match="CUDA tensor"):
            kern.select_aggregate(torch.zeros(20, 50), rule)
    assert sum(kern.LAUNCHES.values()) == 0
