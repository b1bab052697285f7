"""The CUDA kernels on the card against their plain PyTorch versions on
the same tensors, and one card step against one CPU step.  Every test
is marked ``gpu`` and skips inside the test where no card is present.
This file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: scores, weights, medians, trimmed means and the row-order
combines exact (B3 with 0/1 and float weights); l1/d2med/gram within
1e-5 of the largest finite reference magnitude; the fused select
launch: krum / multi_krum weights exact and scores within 1e-5,
geomedian's weights within 1e-5 (where Weiszfeld's iterate sits on a
worker: that worker, its weight within 1%), every aggregate bit-equal to
masked_mean_det of the launch's own weights.  NaN must sit where the plain version has it.
Flash attention (B6) rtol 2e-4 / atol 2e-5 in float32 and 1e-2 in
bfloat16 (one bf16 rounding of the output); the WKV6 scan and its
one-chunk call (B7) within 2e-5 of max|y| and 1e-5 of max|S| (sums in
another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import brsgd_stats as kern
from repro_torch.kernels import flash_attention as fa_kern
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as wkv_kern

RTOL = 1e-5
# LeNet's main path, a ragged d, the largest instance, and the shapes
# paper.robustness ([M, REG_D]) and paper.rate (m = 10) launch at
SHAPES = [(20, 61706), (7, 1003), (64, 4096), (20, 20), (10, 20)]


def close(got, want, rtol=RTOL):
    got = got.double().cpu().numpy()
    want = want.double().cpu().numpy()
    assert got.shape == want.shape
    finite = np.abs(want[np.isfinite(want)])
    scale = max(finite.max(initial=0.0), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def exact(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def mat(m, d, seed=0):
    G = np.random.default_rng(seed).normal(size=(m, d)).astype(np.float32)
    return torch.from_numpy(G).cuda()


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", SHAPES)
def test_cuda_kernels_match_plain_versions(m, d):
    need_card()
    G = mat(m, d, seed=m)
    for needs in (("scores", "l1"), ("gram",), ref.STAT_NAMES):
        got, want = kern.fused_stats(G, needs), ref.fused_stats_ref(G, needs)
        for n in needs:
            (exact if n == "scores" else close)(got[n], want[n])
    check_pass2_and_columns(G)


def check_pass2_and_columns(G):
    """B2, B3 and B4 against their plain versions on G."""
    m = G.shape[0]
    sc, l1 = kern.brsgd_partials(G)
    kth, T = ref.brsgd_thresholds(sc, l1, 0.5, 0.0)
    agg, w = kern.select_mean(G, sc, l1, kth, T)
    sel, _, _, _ = ref.brsgd_select_mask(sc, l1, 0.5, 0.0)
    exact(w, sel.float())
    exact(agg, ref.masked_mean_det(G, sel.float()))
    mask = torch.arange(m, device="cuda") % 3 != 0
    exact(kern.masked_mean(G, mask), ref.masked_mean_det(G, mask))
    got, want = kern.brsgd_stats(G), ref.brsgd_stats_ref(G)
    for i, (a, b) in enumerate(zip(got, want)):
        (close if i == 3 else exact)(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["row", "scattered"])
def test_cuda_kernels_propagate_nan_as_plain_versions(where):
    """One worker holds NaN (a whole row, or every 5th column): the
    kernels' sort and scores treat it as torch.minimum/maximum do."""
    need_card()
    G = mat(20, 61706, seed=3)
    if where == "row":
        G[4] = float("nan")
    else:
        G[4, ::5] = float("nan")
    for needs in (("scores", "l1"), ("gram",), ref.STAT_NAMES):
        got, want = kern.fused_stats(G, needs), ref.fused_stats_ref(G, needs)
        for n in needs:
            (exact if n == "scores" else close)(got[n], want[n])
    check_pass2_and_columns(G)
    for trim_frac in (0.1, 0.49, 0.5):
        exact(kern.trimmed_mean(G, trim_frac),
              ref.trimmed_mean_ref(G, trim_frac))


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", SHAPES)
@pytest.mark.parametrize("trim_frac", [0.1, 0.25, 0.49, 0.5])
def test_trimmed_mean_kernel_matches_plain_version(m, d, trim_frac):
    """B5 sums the kept sorted rows in the plain version's order and
    IEEE-divides, so it agrees bit for bit (0.5 takes trim_k's guard)."""
    need_card()
    G = mat(m, d, seed=m + 1)
    exact(kern.trimmed_mean(G, trim_frac), ref.trimmed_mean_ref(G, trim_frac))


TRIM_FRACS = (0.1, 0.25, 0.49, 0.5)


def check_trimmed(G):
    """B5 on G at every trim fraction: bit-equal to its plain version, a
    second launch the same bits, one launch a call."""
    for trim_frac in TRIM_FRACS:
        kern.reset_launches()
        got = kern.trimmed_mean(G, trim_frac)
        again = kern.trimmed_mean(G, trim_frac)
        torch.cuda.synchronize()
        assert kern.LAUNCHES["trimmed_mean"] == 2
        assert sum(kern.LAUNCHES.values()) == 2
        exact(got, ref.trimmed_mean_ref(G, trim_frac))
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def trimmed_nonfinite(m, d, seed):
    """[m, d] normals with ±inf and NaN in trimmed and kept slots: worker
    0 +inf and the last worker -inf in every 5th column, worker m // 2
    +inf in every 7th, worker (m - 1) // 3 NaN in every third, column 3
    all +inf and column 4 all -inf."""
    G = mat(m, d, seed=seed)
    G[0, ::5] = float("inf")
    G[m - 1, ::5] = -float("inf")
    G[m // 2, 1::7] = float("inf")
    G[(m - 1) // 3, 2::3] = float("nan")
    G[:, 3] = float("inf")
    G[:, 4] = -float("inf")
    return G


@pytest.mark.gpu
@pytest.mark.parametrize("m", range(1, kern.MAX_M + 1))
def test_trimmed_mean_on_nonfinite_columns_and_views(m):
    """B5 at every m (its tuned or bucket instance) on NaN and ±inf in
    trimmed and kept slots, at a d that is a multiple of neither 4 nor
    128 and at one ragged tile, and on a view whose rows start 4 bytes
    past 16 (the column pass copies each row from the boundary before)."""
    need_card()
    for d in (1003, 61):
        G = trimmed_nonfinite(m, d, seed=m + 900)
        check_trimmed(G)
        base = torch.empty(m * d + 1, device="cuda")
        base[1:] = G.reshape(-1)
        view = base[1:].view(m, d)
        assert view.data_ptr() % 16 == 4 and view.is_contiguous()
        check_trimmed(view)


@pytest.mark.gpu
def test_stream_equals_bulk_on_the_card():
    """The streaming fold equals the bulk masked pass bit for bit on the
    card too, for every registered aggregator (the combine is B3)."""
    need_card()
    from repro_torch.configs.base import ByzantineConfig
    from repro_torch.core import engine
    G = mat(20, 4096, seed=5)
    arrival = torch.zeros(4, 20, device="cuda")
    for w, b in enumerate(np.random.default_rng(6).permutation(20) % 4):
        arrival[b, w] = 1.0
    for agg in engine.registered():
        cfg = ByzantineConfig(aggregator=agg, alpha=0.25, quorum=15,
                              max_m=20)
        got, st = engine.stream_aggregate(G, cfg, arrival, None, True)
        active = engine.arrival_active(arrival, 15)
        want, _ = engine.aggregate_local(G, cfg, True, valid=active)
        exact(got, want)
        assert int(st.selected.sum()) <= 15


@pytest.mark.gpu
def test_cuda_wrappers_count_launches_and_refuse_bad_input():
    need_card()
    G = mat(20, 1000)
    kern.reset_launches()
    ops.brsgd_partials(G)
    ops.masked_mean(G, torch.ones(20, device="cuda"))
    assert kern.LAUNCHES == {"fused_stats": 1, "select_mean": 0,
                             "masked_mean": 1, "brsgd_stats": 0,
                             "cwise_median": 0, "trimmed_mean": 0,
                             "brsgd_aggregate": 0, "select_aggregate": 0}
    with pytest.raises(ValueError, match="1 <= m <= 64"):
        kern.fused_stats(torch.zeros(65, 10, device="cuda"), ("l1",))
    with pytest.raises(TypeError):
        kern.masked_mean(G.double(), torch.ones(20, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        kern.brsgd_stats(G.T.contiguous().T)
    with pytest.raises(ValueError, match="contiguous"):
        kern.cwise_median(G.T.contiguous().T)
    with pytest.raises(ValueError, match="thresholds"):
        kern.select_mean(G, torch.zeros(20, device="cuda"),
                         torch.zeros(20, device="cuda"),
                         torch.tensor(0.0), torch.tensor(1.0))


# ---------------------------------------------------------------------------
# the column pass: B1 without gram, B4 and the median alone
# ---------------------------------------------------------------------------

# B1's needs that take the column pass (every subset without gram), and
# gram + d2med, which takes the gram kernel
COLUMN_NEEDS = [("scores",), ("l1",), ("d2med",), ("scores", "l1"),
                ("scores", "d2med"), ("l1", "d2med"),
                ("scores", "l1", "d2med"), ("d2med", "gram")]


def check_column_pass(G):
    """B1 at each of COLUMN_NEEDS, B4 and the median alone against their
    plain versions: scores, medians and B4's mean exact, l1, d2med and
    gram within RTOL."""
    for needs in COLUMN_NEEDS:
        got, want = kern.fused_stats(G, needs), ref.fused_stats_ref(G, needs)
        assert set(got) == set(needs)
        for n in needs:
            (exact if n == "scores" else close)(got[n], want[n])
    got, want = kern.brsgd_stats(G), ref.brsgd_stats_ref(G)
    for i, (a, b) in enumerate(zip(got, want)):
        (close if i == 3 else exact)(a, b)
    exact(kern.cwise_median(G), ref.cwise_median_ref(G))


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", SHAPES + [(20, 8_388_608), (20, 2_000_003)])
def test_column_pass_matches_plain_versions(m, d):
    need_card()
    check_column_pass(mat(m, d, seed=m + d % 97))


@pytest.mark.gpu
@pytest.mark.parametrize("m", kern.TUNED_M)
@pytest.mark.parametrize("d", [61, 1003, 4098])
@pytest.mark.parametrize("where", ["row", "columns"])
def test_column_pass_every_m_with_nan(m, d, where):
    """Every instance, at d < 128 (one ragged tile) and d % 4 != 0 (rows
    that do not start on 16 bytes): a NaN worker row, or NaN entries
    scattered over the columns and one column all NaN."""
    need_card()
    G = mat(m, d, seed=m * d)
    if where == "row":
        G[m // 3] = float("nan")
    else:
        cols = torch.arange(0, d, 7, device="cuda")
        G[cols % m, cols] = float("nan")
        G[:, 3] = float("nan")
    check_column_pass(G)


@pytest.mark.gpu
def test_column_pass_score_counts_fill_their_planes():
    """One block over 2^16 - 1 tiles, the most a block may take: its
    bit-sliced score counters use all 16 planes and stay exact (a ragged
    last tile too).  One tile more on one block is refused."""
    need_card()
    import ctypes
    from repro_torch.kernels import _build
    m = 4
    lib = _build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for n_tiles, rc_want in ((2 ** 16 - 1, 0), (2 ** 16, 1)):
        d = 128 * (n_tiles - 1) + 5
        G = mat(m, d, seed=21)
        sc = torch.empty((1, m), device="cuda")
        rc = lib.brsgd_fused_stats(
            ctypes.c_void_p(G.data_ptr()), m, d, kern.NEED_BITS["scores"],
            ctypes.c_void_p(sc.data_ptr()), None, None, None, 1,
            kern.column_stages(m, kern.NEED_BITS["scores"]), stream)
        assert rc == rc_want                  # 1: cudaErrorInvalidValue
        if rc == 0:
            exact(sc[0], ref.fused_stats_ref(G, ("scores",))["scores"])


@pytest.mark.gpu
def test_column_pass_on_a_view_off_16_bytes():
    """G a contiguous view whose data starts 4 bytes past 16: every row
    is copied from the 16-byte boundary before it."""
    need_card()
    base = mat(1, 20 * 1003 + 1, seed=9).reshape(-1)
    G = base[1:].view(20, 1003)
    assert G.data_ptr() % 16 == 4 and G.is_contiguous()
    check_column_pass(G)


# the fused brsgd launch: chip_smoke's CHECK_SHAPES (resident in shared
# memory) and one shape whose G is not, so pass 2 reads it again
FUSED_SHAPES = SHAPES + [(20, 2_000_003)]
FUSED_CASES = [(0.5, 0.0), (0.25, 0.0), (0.5, 1e-6), (0.25, 5.0)]


def check_fused(G, beta, threshold):
    """The fused kernel against the plain version on G: scores exact and
    l1 within RTOL; kth, 𝔗, the masks and w exact against the plain
    threshold and mask steps applied to the kernel's own scores and l1;
    the aggregate bit-equal to masked_mean_det(G, w); a second launch the
    same bits; one launch each."""
    kern.reset_launches()
    r = kern.brsgd_aggregate(G, beta, threshold)
    again = kern.brsgd_aggregate(G, beta, threshold)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["brsgd_aggregate"] == 2
    assert sum(kern.LAUNCHES.values()) == 2
    want = ref.fused_stats_ref(G, ("scores", "l1"))
    exact(r.scores, want["scores"])
    close(r.l1, want["l1"])
    kth, T = ref.brsgd_thresholds(r.scores, r.l1, beta, threshold)
    sel, c1, c2 = ref.brsgd_masks(r.scores, r.l1, kth, T)
    for got, w in ((r.kth, kth), (r.threshold, T), (r.selected, sel),
                   (r.c1, c1), (r.c2, c2), (r.w, sel.float())):
        exact(got, w)
    exact(r.agg, ref.masked_mean_det(G, r.w))
    for a, b in zip(again, r):
        if b is None:
            assert a is None
        else:
            exact(a, b)
    return r


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", FUSED_SHAPES)
@pytest.mark.parametrize("beta,threshold", FUSED_CASES)
def test_fused_brsgd_kernel_matches_plain_version(m, d, beta, threshold):
    need_card()
    G = mat(m, d, seed=m + 2)
    G[: max(1, m // 4)] *= 30.0                      # outlying workers
    plan = kern.launch_plan(G)
    assert plan.resident == (d != 2_000_003)
    check_fused(G, beta, threshold)


@pytest.mark.gpu
@pytest.mark.parametrize("m", kern.TUNED_M)
@pytest.mark.parametrize("where", ["row", "scattered"])
def test_fused_brsgd_kernel_every_m_with_a_nan_worker(m, where):
    need_card()
    G = mat(m, 5003, seed=m + 40)
    if where == "row":
        G[m // 2] = float("nan")
    else:
        G[m // 2, ::7] = float("nan")
    check_fused(G, 0.5, 0.0)
    check_fused(G, 0.5, 1.0)


@pytest.mark.gpu
def test_fused_brsgd_kernel_not_resident_with_a_nan_worker():
    need_card()
    G = mat(20, 2_000_003, seed=9)
    G[3, ::11] = float("nan")
    check_fused(G, 0.5, 0.0)


@pytest.mark.gpu
def test_brsgd_aggregation_is_one_launch():
    """engine.aggregate_local(brsgd, return_state=True) launches the
    fused kernel once and nothing else of the port; the state is views
    of its buffers, equal to the plain composition's."""
    need_card()
    from repro_torch.configs.base import ByzantineConfig
    from repro_torch.core import engine
    G = mat(20, 61706, seed=12)
    G[:5] *= 1e10
    cfg = ByzantineConfig(aggregator="brsgd", alpha=0.25)
    ops.reset_launches()
    agg, st = engine.aggregate_local(G, cfg, return_state=True)
    torch.cuda.synchronize()
    assert {k: n for k, n in ops.launches().items() if n} == \
        {"brsgd_aggregate": 1}
    assert not st.selected[:5].any()
    r = ref.brsgd_aggregate_plain(G, cfg.beta, cfg.threshold)
    exact(st.selected, r.selected)
    exact(agg, ref.masked_mean_det(G, st.selected.float()))


@pytest.mark.gpu
def test_fused_brsgd_wrapper_refuses_bad_input():
    need_card()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kern.brsgd_aggregate(torch.zeros(20, 10), 0.5, 0.0)
    with pytest.raises(ValueError, match="1 <= m <= 64"):
        kern.brsgd_aggregate(torch.zeros(65, 10, device="cuda"), 0.5, 0.0)
    with pytest.raises(TypeError):
        kern.brsgd_aggregate(torch.zeros(20, 10, device="cuda",
                                         dtype=torch.float64), 0.5, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        kern.brsgd_aggregate(mat(20, 64).T.contiguous().T, 0.5, 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("agg", ["brsgd", "mean", "median", "krum",
                                 "trimmed_mean", "multi_krum", "geomedian"])
def test_card_step_matches_cpu_step(agg):
    """Scale is deterministic, so both devices attack the same rows.
    trimmed_mean runs at alpha = 0.1, which its k = 2 trims away: at
    0.25 three scaled rows survive in some columns, the parameters reach
    ~1e6 there, and a tolerance relative to the leaf's largest value
    would pass a wrong aggregate on the other columns."""
    need_card()
    from repro_torch.configs.base import ByzantineConfig
    from repro_torch.configs.lenet_fmnist import LeNetConfig
    from repro_torch.core.simulate import make_sim_step
    from repro_torch.data.pipeline import ImageWorkerPipeline
    from repro_torch.models import lenet
    from repro_torch.models.params import init_params
    alpha = 0.1 if agg == "trimmed_mean" else 0.25
    bcfg = ByzantineConfig(aggregator=agg, attack="scale", alpha=alpha)
    batch = ImageWorkerPipeline(20, 32, seed=0, byz=bcfg).batch(0, 8)
    p_cpu = init_params(lenet.lenet_defs(LeNetConfig()),
                        torch.Generator().manual_seed(0))
    new_cpu, m_cpu = make_sim_step(lenet.lenet_loss, bcfg, 0.05, "cpu")(
        p_cpu, batch, torch.Generator())
    new_gpu, m_gpu = make_sim_step(lenet.lenet_loss, bcfg, 0.05)(
        {k: v.cuda() for k, v in p_cpu.items()}, batch,
        torch.Generator(device="cuda"))
    exact(m_gpu["selected"], m_cpu["selected"])
    for k in new_cpu:
        close(new_gpu[k], new_cpu[k])


# ---------------------------------------------------------------------------
# the fused select launch (krum, multi_krum, geomedian) and the rebuilt B3
# ---------------------------------------------------------------------------

SELECT_RULES = ["krum", "multi_krum", "geomedian"]


def select_args(rule, m):
    f = max(1, int(0.25 * m))
    if rule == "geomedian":
        return {"iters": 16, "eps": 1e-6}
    args = {"n_close": max(1, m - f - 2)}
    if rule == "multi_krum":
        args["k"] = max(1, m - f)
    return args


ON_WORKER = 1e-2   # Weiszfeld's iterate within 1% of max‖g_i‖ of a worker
ON_WORKER_W = 1e-2  # the weight there: within 1% of the plain version's


def check_geomedian(G, w, want_w, S, agg=None, want_agg=None):
    """geomedian's weights (and aggregate) against the plain version.
    w_i = 1/‖g_i − z‖ with ‖g_i − z‖² = S_ii − 2(Sw)_i/W + wᵀSw/W², a
    difference of gram terms up to max S_ii: where the iterate z sits on
    worker i, w_i is set by rounding (a duplicate that holds half the
    rows, as at m = 4, is the geometric median itself).  So: rows the
    plain iterate stays ON_WORKER · √max S_ii or farther from hold w
    within RTOL of the largest such weight; rows nearer must be copies
    of one worker, the card's argmax, with w within ON_WORKER_W of the
    plain's; the aggregate within RTOL of the plain one, plus, where the
    iterate sits on worker i, ON_WORKER_W of max|g_i − agg| (the first-
    order effect of that weight)."""
    if bool(want_w.isnan().any()):
        close(w, want_w)
        if agg is not None:
            close(agg, want_agg)
        return
    root = float(S.diagonal().max()) ** 0.5
    on = want_w * root * ON_WORKER > 1.0
    close(w[~on], want_w[~on])
    atol = 0.0
    if bool(on.any()):
        i = int(torch.argmax(w))
        rows = G[on]
        assert bool((rows == G[i]).all()), "the iterate sits on two workers"
        ratio = (w[on] / want_w[on]).double().cpu()
        assert float((ratio - 1.0).abs().max()) <= ON_WORKER_W, ratio
        if agg is not None:
            atol = ON_WORKER_W * float((G[i] - want_agg).abs().max())
    if agg is not None:
        got, ref_agg = agg.double().cpu(), want_agg.double().cpu()
        scale = float(ref_agg[ref_agg.isfinite()].abs().max())
        np.testing.assert_allclose(got.numpy(), ref_agg.numpy(), rtol=0,
                                   atol=RTOL * scale + atol)


def check_select(G, rule, args):
    """The fused launch against its plain version on G: gram (and
    d2med) within RTOL; krum / multi_krum scores within RTOL, weights
    exact against the plain rule on the launch's own scores and against
    the plain composition; geomedian's weights within RTOL of both; the
    aggregate bit-equal to masked_mean_det(G, w); a second launch the
    same bits; one launch each.  (geomedian where the iterate sits on a
    worker: see check_geomedian.)"""
    kern.reset_launches()
    r = kern.select_aggregate(G, rule, **args)
    again = kern.select_aggregate(G, rule, **args)
    torch.cuda.synchronize()
    assert kern.LAUNCHES["select_aggregate"] == 2
    assert sum(kern.LAUNCHES.values()) == 2
    want = ref.select_aggregate_plain(G, rule, **args)
    close(r.gram, want.gram)
    if rule == "geomedian":
        close(r.d2med, want.d2med)
        check_geomedian(G, r.w, want.w, want.gram, r.agg, want.agg)
        check_geomedian(G, r.w, ref.geomedian_weights(
            r.gram, r.d2med, args["iters"], args["eps"]), r.gram)
    else:
        close(r.scores, want.scores)
        own = (ref.krum_weights(r.scores) if rule == "krum"
               else ref.multi_krum_weights(r.scores, args["k"]))
        exact(r.w, own)
        exact(r.w, want.w)
    exact(r.selected, r.w > 0)
    exact(r.agg, ref.masked_mean_det(G, r.w))
    for a, b in zip(again, r):
        if b is None:
            assert a is None
        else:
            exact(a, b)
    return r


@pytest.mark.gpu
@pytest.mark.parametrize("m", kern.TUNED_M)
@pytest.mark.parametrize("rule", SELECT_RULES)
def test_fused_select_kernel_matches_plain_version(m, rule):
    """Every m, resident in shared memory ([m, 5003]), a NaN worker and
    duplicate rows."""
    need_card()
    G = mat(m, 5003, seed=m + 60)
    G[: max(1, m // 4)] *= -4.0                       # outlying workers
    assert kern.launch_plan(G, rule).resident
    check_select(G, rule, select_args(rule, m))
    G[m - 1] = G[m // 2]                              # a duplicate: ties
    r = check_select(G, rule, select_args(rule, m))
    if rule != "geomedian":
        assert float(r.scores[m - 1]) == float(r.scores[m // 2])
    G[m // 2, ::7] = float("nan")
    check_select(G, rule, select_args(rule, m))


@pytest.mark.gpu
@pytest.mark.parametrize("m", range(1, kern.MAX_M + 1))
def test_every_wrapper_at_every_worker_count(m):
    """Every m in 1..64, on its tuned or bucket instance, at the ragged
    [m, 1003] with one worker's row NaN in every third column: B1 (the
    column pass at every non-gram subset, gram), B2, B3, B4, the median
    alone, B5 at every trim fraction, the fused brsgd launch and the fused
    select launch of each gram rule against their plain versions; then
    every rule through aggregate_local, fixed and elastic, against the
    same call on the CPU (the selection equal; the aggregate exact, within
    RTOL for geomedian and the elastic select rules)."""
    need_card()
    G = mat(m, 1003, seed=m + 700)
    G[: m // 4] *= -4.0
    G[(m - 1) // 2, ::3] = float("nan")
    check_column_pass(G)
    check_pass2_and_columns(G)
    check_trimmed(G)
    check_fused(G, 0.5, 0.0)
    for rule in SELECT_RULES:
        check_select(G, rule, select_args(rule, m))
    from repro_torch.configs.base import ByzantineConfig
    from repro_torch.core import engine
    valid = (torch.arange(m) % 3 != 1).float()
    for agg in engine.registered():
        cfg = ByzantineConfig(aggregator=agg, alpha=0.25)
        for v in (None, valid):
            got, st = engine.aggregate_local(
                G, cfg, True, valid=None if v is None else v.cuda())
            want, wst = engine.aggregate_local(G.cpu(), cfg, True, valid=v)
            if agg == "geomedian" or (v is not None and agg not in (
                    "median", "trimmed_mean", "mean")):
                close(got, want)
            else:
                exact(got, want)
            if st is not None:
                exact(st.selected, wst.selected)


@pytest.mark.gpu
@pytest.mark.parametrize("rule", SELECT_RULES)
@pytest.mark.parametrize("m,d", [(20, 2_000_003), (64, 300_001), (7, 1_000_003)])
def test_fused_select_kernel_not_resident(rule, m, d):
    need_card()
    G = mat(m, d, seed=d % 97)
    G[:3] *= -4.0
    assert not kern.launch_plan(G, rule).resident
    check_select(G, rule, select_args(rule, m))
    G[1, ::11] = float("nan")
    check_select(G, rule, select_args(rule, m))


def nonfinite_workers(m, d, seed):
    """Outlying workers and two workers with non-finite columns: worker 1
    NaN in every 9th column, worker 3 +inf, -inf and NaN in others.  Both
    score NaN: krum keeps worker 1 (the first NaN), so worker 3 is left
    out by every select rule but the mean."""
    G = mat(m, d, seed=seed)
    G[m - m // 4:] *= -4.0
    G[1, ::9] = float("nan")
    G[3, 2::9] = float("inf")
    G[3, 5::9] = float("-inf")
    G[3, 7::11] = float("nan")
    return G


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", [(20, 61706), (20, 2_000_003), (12, 61706),
                                 (33, 61706)])
def test_combines_with_an_unselected_nonfinite_worker(m, d):
    """The combines sum every row, weight 0 included, as the reference's
    w @ g does (0·NaN and 0·inf are NaN): B2, B3, the fused brsgd launch
    and the fused select launch of every gram rule bit-equal to
    masked_mean_det of their own weights, NaN in the same places, where
    the rules leave a non-finite worker out; G resident in shared memory
    at d = 61706 (m = 20), not at 2000003, and on the bucket instances at
    m = 12 and 33."""
    need_card()
    G = nonfinite_workers(m, d, seed=m + 90)
    if d > 1_000_000:
        assert not kern.launch_plan(G, "krum").resident
    elif m == 20:
        assert kern.launch_plan(G, "krum").resident
    check_pass2_and_columns(G)
    r = check_fused(G, 0.5, 0.0)
    assert not bool(r.selected[3])
    assert bool(r.agg[2::9].isnan().all())
    for rule in SELECT_RULES:
        r = check_select(G, rule, select_args(rule, m))
        if rule != "geomedian":
            assert not bool(r.selected[3])
            assert bool(r.agg[5::9].isnan().all())
    w = torch.ones(m, device="cuda")
    w[3] = 0.0
    got = kern.masked_mean(G, w)
    exact(got, ref.masked_mean_det(G, w))
    assert bool(got[2::9].isnan().all())


@pytest.mark.gpu
@pytest.mark.parametrize("agg", ["mean", "krum", "multi_krum", "geomedian",
                                 "brsgd"])
def test_aggregate_local_is_one_device_kernel(agg):
    """A fixed round's engine.aggregate_local(return_state=True) is one
    device kernel (torch.profiler; a host-to-device copy would count
    too): the fused launch, or B3 alone for the mean, and nothing else of
    the port; the state is views of what it wrote."""
    need_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ByzantineConfig
    from repro_torch.core import engine
    G = mat(20, 61706, seed=13)
    G[:5] *= 1e10
    cfg = ByzantineConfig(aggregator=agg, alpha=0.25)
    engine.aggregate_local(G, cfg, return_state=True)
    torch.cuda.synchronize()
    for _ in range(5):      # a trace that lost its records: once more
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            agg_out, st = engine.aggregate_local(G, cfg, return_state=True)
            torch.cuda.synchronize()
        device = {e.key: e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA}
        if device:
            break
    assert sum(device.values()) == 1, device
    name = {"mean": "masked_mean", "brsgd": "brsgd_aggregate"}.get(
        agg, "select_aggregate")
    assert {k: n for k, n in ops.launches().items() if n} == {name: 1}
    exact(agg_out, ref.masked_mean_det(G, st.weights if agg != "brsgd"
                                       else st.selected.float()))
    if agg in ("krum", "multi_krum"):
        assert not st.selected[:5].any()


@pytest.mark.gpu
def test_median_aggregate_local_is_one_device_kernel():
    """A median engine.aggregate_local is the median-only launch and no
    other device kernel (B4 wrote mean and partials it threw away, then
    summed them: three)."""
    need_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ByzantineConfig
    from repro_torch.core import engine
    G = mat(20, 61706, seed=14)
    cfg = ByzantineConfig(aggregator="median")
    engine.aggregate_local(G, cfg)
    torch.cuda.synchronize()
    for _ in range(5):      # a trace that lost its records: once more
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = engine.aggregate_local(G, cfg)
            torch.cuda.synchronize()
        device = {e.key: e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA}
        if device:
            break
    assert sum(device.values()) == 1, device
    assert {k: n for k, n in ops.launches().items() if n} == \
        {"cwise_median": 1}
    exact(out, ref.cwise_median_ref(G))


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", SHAPES + [(20, 8_388_608)])
def test_rebuilt_masked_mean_is_bit_equal_with_any_weights(m, d):
    """B3 sums every row (weight 0 included) and Σw in row order, so it
    equals masked_mean_det bit for bit with 0/1 masks, float weights,
    unit weights (the mean, which also writes w and w > 0) and an empty
    mask."""
    need_card()
    G = mat(m, d, seed=m + d % 89)
    rng = np.random.default_rng(m)
    for w in (torch.as_tensor(rng.random(m) < 0.6, device="cuda"),
              torch.as_tensor(rng.random(m).astype(np.float32), device="cuda"),
              torch.zeros(m, dtype=torch.bool, device="cuda")):
        exact(kern.masked_mean(G, w), ref.masked_mean_det(G, w))
    r = kern.select_aggregate(G, "mean")
    exact(r.agg, ref.masked_mean_det(G, torch.ones(m, device="cuda")))
    exact(r.w, torch.ones(m))
    assert bool(r.selected.all())


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", [(20, 8_388_608), (64, 100_003), (5, 1003)])
def test_standalone_gram_pass_within_its_gate(m, d):
    need_card()
    G = mat(m, d, seed=m + 7)
    got = kern.fused_stats(G, ("gram", "d2med"))
    want = ref.fused_stats_ref(G, ("gram", "d2med"))
    close(got["gram"], want["gram"])
    close(got["d2med"], want["d2med"])
    exact(got["gram"], got["gram"].T)                  # one bit pattern


# ---------------------------------------------------------------------------
# B6 and B7 at the shapes of chip_smoke.py's phase 3
# ---------------------------------------------------------------------------

# (B, H, Hkv, S, D, window, dtype): the qwen3-0.6b prefill (batch 4, and
# batch 1 at the serve loop's 512 and 256 buckets), a ragged S, a window, D = 64 and 80, and bfloat16; S = 5 (below one mma tile), S one
# past a 128-row query tile and a 64-row key tile, groups 1, 2 and 8, and
# every D in both types (96: phi-3-vision-4.2b's prefill of 576 patches
# and 512 tokens)
FLASH_CASES = [(4, 16, 8, 512, 128, 0, torch.float32),
               (1, 16, 8, 512, 128, 0, torch.float32),
               (1, 16, 8, 256, 128, 0, torch.float32),
               (1, 16, 8, 200, 128, 0, torch.float32),
               (1, 16, 8, 512, 128, 64, torch.float32),
               (2, 8, 4, 300, 64, 0, torch.float32),
               (1, 8, 8, 256, 80, 0, torch.float32),
               (4, 16, 8, 512, 128, 0, torch.bfloat16),
               (2, 4, 4, 5, 64, 0, torch.float32),
               (1, 2, 2, 5, 128, 0, torch.bfloat16),
               (1, 16, 2, 129, 128, 0, torch.float32),
               (1, 8, 1, 191, 128, 100, torch.float32),
               (1, 4, 2, 65, 80, 0, torch.bfloat16),
               (2, 8, 4, 300, 64, 48, torch.bfloat16),
               (4, 32, 32, 1088, 96, 0, torch.float32),
               (2, 8, 4, 211, 96, 48, torch.bfloat16)]
# (B, H, Q, K, log-decay range): rwkv6-7b's chunk with w in (e^-1, 1),
# w down to e^-3 (the clamps bite), a ragged last chunk, K = 32
WKV_CASES = [(4, 64, 64, 64, 1.0), (4, 64, 64, 64, 3.0),
             (4, 64, 40, 64, 1.0), (4, 32, 64, 32, 1.0)]
# wkv6_seq: prompt lengths around one 64-token chunk and rwkv6-7b's 512
WKV_SEQ_S = [1, 63, 64, 65, 512]


def _bshd(B, S, H, D, seed, dtype):
    """A [B,H,S,D] view of [B,S,H,D] data: the model's layout."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, S, H, D, generator=g, device="cuda")
    return x.to(dtype).transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,S,D,win,dtype", FLASH_CASES)
def test_flash_attention_kernel_matches_plain_version(B, H, Hkv, S, D, win,
                                                      dtype):
    need_card()
    q, k, v = (_bshd(B, S, h, D, i, dtype)
               for i, h in enumerate((H, Hkv, Hkv)))
    fa_kern.reset_launches()
    got = fa_kern.flash_attention(q, k, v, win)
    want = ref.flash_attention_ref(q, k, v, win)
    torch.cuda.synchronize()
    assert fa_kern.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.stride() == q.stride()
    tol = 2e-4 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol / 10 if dtype == torch.float32
                               else tol)
    # contiguous [B,H,S,D] inputs give the same numbers
    again = fa_kern.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), win)
    assert torch.equal(again, got)


def _wkv_case(B, H, Q, K, decay, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn(B, H, Q, K, generator=g, device="cuda")
               for _ in range(3))
    w = torch.exp(-decay * torch.rand(B, H, Q, K, generator=g,
                                      device="cuda"))
    u = torch.randn(H, K, generator=g, device="cuda")
    S0 = torch.randn(B, H, K, K, generator=g, device="cuda")
    return r, k, v, w, u, S0


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Q,K,decay", WKV_CASES)
def test_wkv6_chunk_kernel_matches_plain_version(B, H, Q, K, decay):
    need_card()
    ins = _wkv_case(B, H, Q, K, decay)
    wkv_kern.reset_launches()
    y, S = wkv_kern.wkv6_chunk(*ins)
    yp, Sp = ref.wkv6_chunk_plain(*ins)
    torch.cuda.synchronize()
    assert wkv_kern.LAUNCHES["wkv6_seq"] == 1
    close(y, yp, 2e-5)
    close(S, Sp, 1e-5)
    if decay <= 1.0:           # the clamps do not bite: the recurrence too
        ys, Ss = ref.wkv6_chunk_ref(*ins)
        close(y, ys, 2e-5)
        close(S, Ss, 1e-4)
    # one chunk of a [B,H,S,K] buffer, passed as a strided view
    r, k, v, w, u, S0 = ins
    big = [torch.cat([x, x], dim=2) for x in (r, k, v, w)]
    yv, Sv = wkv_kern.wkv6_chunk(*(x[:, :, Q:] for x in big), u, S0)
    assert torch.equal(yv, y) and torch.equal(Sv, S)


@pytest.mark.gpu
@pytest.mark.parametrize("S", WKV_SEQ_S)
@pytest.mark.parametrize("K", [32, 64])
@pytest.mark.parametrize("decay", [1.0, 3.0])
def test_wkv6_seq_kernel_matches_plain_version(S, K, decay):
    """One launch for the whole prompt, chunks of 64 (the last ragged),
    the state carried on chip from a nonzero S0; rwkv6-7b's [4, 512, 64,
    64] at S = 512, K = 64."""
    need_card()
    B, H = (4, 64) if (S, K) == (512, 64) else (2, 8)
    r, k, v, w, u, S0 = _wkv_case(B, H, S, K, decay, seed=S + K)
    r, k, v, w = (x.transpose(1, 2).contiguous() for x in (r, k, v, w))
    wkv_kern.reset_launches()
    y, Sf = wkv_kern.wkv6_seq(r, k, v, w, u, S0, 64)
    yp, Sp = ref.wkv6_seq_plain(r, k, v, w, u, S0, 64)
    torch.cuda.synchronize()
    assert wkv_kern.LAUNCHES["wkv6_seq"] == 1
    assert y.shape == (B, S, H, K) and Sf.shape == (B, H, K, K)
    close(y, yp, 2e-5)
    close(Sf, Sp, 1e-5)
    # the model passes [B,S,H,K] views of wider buffers as they are
    big = [torch.cat([x, x], dim=3) for x in (r, k, v, w)]
    yv, Sv = wkv_kern.wkv6_seq(*(x[..., K:] for x in big), u, S0, 64)
    assert torch.equal(yv, y) and torch.equal(Sv, Sf)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [300, 512])
@pytest.mark.parametrize("decay", [1.0, 3.0])
def test_wkv6_seq_kernel_at_the_serve_loop_prefill(S, decay):
    """The serve loop's rwkv6-7b prefill: batch 1, all 64 heads, K = 64,
    a ragged prompt length and a whole number of chunks."""
    need_card()
    r, k, v, w, u, S0 = _wkv_case(1, 64, S, 64, decay, seed=S + 64)
    r, k, v, w = (x.transpose(1, 2).contiguous() for x in (r, k, v, w))
    wkv_kern.reset_launches()
    y, Sf = wkv_kern.wkv6_seq(r, k, v, w, u, S0, 64)
    yp, Sp = ref.wkv6_seq_plain(r, k, v, w, u, S0, 64)
    torch.cuda.synchronize()
    assert wkv_kern.LAUNCHES["wkv6_seq"] == 1
    close(y, yp, 2e-5)
    close(Sf, Sp, 1e-5)


@pytest.mark.gpu
def test_sequence_wrappers_refuse_bad_input():
    need_card()
    q = torch.zeros(1, 2, 8, 48, device="cuda")
    with pytest.raises(ValueError, match="no kernel instance"):
        fa_kern.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="multiple"):
        fa_kern.flash_attention(torch.zeros(1, 3, 8, 64, device="cuda"),
                                torch.zeros(1, 2, 8, 64, device="cuda"),
                                torch.zeros(1, 2, 8, 64, device="cuda"))
    ins = _wkv_case(1, 2, 65, 32, 1.0)
    with pytest.raises(ValueError, match="no kernel instance"):
        wkv_kern.wkv6_chunk(*ins)
    r, k, v, w, u, S0 = _wkv_case(1, 2, 8, 32, 1.0)
    with pytest.raises(TypeError):
        wkv_kern.wkv6_chunk(r.double(), k, v, w, u, S0)
    # rows that do not start on 16 bytes: an odd element offset, and a
    # row stride of 65 floats; the wrappers raise, they never copy
    flat = torch.zeros(1 + 2 * 8 * 64 * 4, device="cuda")
    off = flat[1:].view(2, 8, 4, 64).transpose(1, 2)
    wide = torch.zeros(2, 8, 4, 65, device="cuda")[..., 1:].transpose(1, 2)
    for bad in (off, wide):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa_kern.flash_attention(bad, bad[:, :2], bad[:, :2])
    rs = torch.zeros(1, 8, 2, 33, device="cuda")[..., 1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        wkv_kern.wkv6_seq(rs, rs, rs, rs, u, S0[:1], 4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b"])
def test_serve_path_on_the_card_matches_the_cpu(arch):
    """Reduced config: the card's prefill launches B6 once per dense
    layer or B7 once per rwkv layer (all its chunks), decode neither,
    and the logits equal the CPU's within 1e-4 of the largest."""
    need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    cfg = get_config(arch).reduced()
    p_cpu = PM.init_params(TF.param_defs(cfg),
                           torch.Generator().manual_seed(0))
    p_gpu = _to(p_cpu, "cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 80),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        cache = TF.init_cache(cfg, 2, 88, torch.float32, dev)
        ops.reset_launches()
        logits, cache = TF.prefill_cache(cfg, params, tokens.to(dev), cache)
        pre = ops.launches()
        ops.reset_launches()
        tok = logits[:, -1].argmax(-1)[:, None]
        logits2, _ = TF.decode_step(cfg, params, cache, tok, 80)
        out[dev] = (logits.cpu(), logits2.cpu(), pre, ops.launches())
    close(out["cuda"][0], out["cpu"][0], 1e-4)
    close(out["cuda"][1], out["cpu"][1], 1e-4)
    want = ({"flash_attention": cfg.n_layers} if arch == "qwen3-0.6b"
            else {"wkv6_seq": cfg.n_layers})   # one launch a layer
    assert {k: n for k, n in out["cuda"][2].items() if n} == want
    assert not any(out["cuda"][3].values())          # decode: no kernel


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# the continuous-batching serve loop: one CUDA graph of the decode step
# ---------------------------------------------------------------------------

LOOP_PROMPTS = (3, 5, 7, 4, 6, 5)
LOOP_GENS = (6, 4, 8, 3, 5, 7)
LOOP_MAX_LEN = 24


def _loop_run(loop, prompts, gens):
    rids = [loop.submit(p, g) for p, g in zip(prompts, gens)]
    done = loop.run()
    assert set(rids) <= set(done)
    return [done[r] for r in rids]


def _decode_margins(cfg, params, prompt, tokens, max_len):
    """(top1 - top2) / max|logit| of the logits that decide each token of
    a batch-1 teacher-forced decode of ``tokens`` (on params' device)."""
    from repro_torch.models import transformer as TF
    dev = next(iter(params.values())).device
    cache = TF.init_cache(cfg, 1, max_len, torch.float32, dev)
    lg, cache = TF.prefill_cache(cfg, params, torch.as_tensor(
        prompt, device=dev)[None], cache)
    lg, out = lg[0, -1], []
    for i, t in enumerate(tokens):
        top = torch.topk(lg, 2).values
        out.append(float((top[0] - top[1]) / lg.abs().max()))
        lg, cache = TF.decode_step(cfg, params, cache,
                                   torch.tensor([[int(t)]], device=dev),
                                   len(prompt) + i)
        lg = lg[0, 0]
    return out


def _near_tie_equal(got, want, margins, tol=1e-4) -> bool:
    """Tokens equal, or first different where the reference's top-two
    logits lie within tol of its max|logit| (then True)."""
    diff = np.flatnonzero(np.asarray(got) != np.asarray(want))
    if not diff.size:
        return False
    assert margins[diff[0]] <= tol, (diff[0], margins[diff[0]])
    return True


def _loop_setup(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    cfg = get_config(arch).reduced()
    p_cpu = PM.init_params(TF.param_defs(cfg),
                           torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=p) for p in LOOP_PROMPTS]
    return cfg, p_cpu, _to(p_cpu, "cuda"), prompts


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b"])
def test_serve_loop_on_the_card_matches_the_cpu(arch):
    """The loop on the card (one decode graph) against the loop on the
    CPU, reduced config: tokens under the near-tie rule; B6 / B7 once a
    layer per admission, nothing in the decode step; one graph across a
    second wave of requests; the prefill shapes of the policy."""
    need_card()
    from repro_torch.serving import ServeLoop
    cfg, p_cpu, p_gpu, prompts = _loop_setup(arch)
    want = _loop_run(ServeLoop(cfg, 4, LOOP_MAX_LEN, params=p_cpu), prompts,
                     LOOP_GENS)
    loop = ServeLoop(cfg, 4, LOOP_MAX_LEN, params=p_gpu)
    ops.reset_launches()
    got = _loop_run(loop, prompts, LOOP_GENS)
    for p, g, w in zip(prompts, got, want):
        _near_tie_equal(g, w, _decode_margins(cfg, p_cpu, p, w,
                                              LOOP_MAX_LEN))
    kernel = "flash_attention" if arch == "qwen3-0.6b" else "wkv6_seq"
    n = len(prompts) * cfg.n_layers
    assert {k: v for k, v in ops.launches().items() if v} == {kernel: n}
    assert loop.prefill_launches == {kernel: n}
    assert loop.decode_launches == {}
    assert loop.decode_graphs() == 1
    assert loop.prefill_shapes() == (2 if arch == "qwen3-0.6b" else 5)
    _loop_run(loop, prompts[:2], (3, 9))               # churn: a new wave
    assert loop.decode_graphs() == 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b"])
def test_serve_loop_hot_swap_on_the_card(arch, tmp_path):
    """A swap to negated params after decode step 4 on the card: two
    decode graphs (one a parameter slot), tokens equal to an eager
    batch-1 decode on the card that switches params there."""
    need_card()
    from repro_torch.checkpoint import ckpt
    from repro_torch.models import transformer as TF
    from repro_torch.serving import HotSwapper, ServeLoop
    cfg, p_cpu, _, prompts = _loop_setup(arch)
    d = str(tmp_path)
    ckpt.save(d, p_cpu, step=1)
    neg = _neg(p_cpu)
    swapper = HotSwapper(d, like=p_cpu, device="cuda")
    loop = ServeLoop(cfg, 2, LOOP_MAX_LEN, swapper=swapper)
    rids = [loop.submit(p, 10) for p in prompts[:2]]

    def on_step(lp, s):
        if s == 4:
            ckpt.save(d, neg, step=2)

    done = loop.run(on_step=on_step)
    assert (swapper.swap_count, swapper.loaded_step) == (1, 2)
    assert loop.decode_graphs() == 2
    p_old, p_new = _to(p_cpu, "cuda"), _to(neg, "cuda")
    for rid, prompt in zip(rids, prompts[:2]):
        cache = TF.init_cache(cfg, 1, LOOP_MAX_LEN, torch.float32, "cuda")
        lg, cache = TF.prefill_cache(cfg, p_old, torch.as_tensor(
            prompt, device="cuda")[None], cache)
        lg, toks, margins = lg[0, -1], [], []
        for i in range(10):
            top = torch.topk(lg, 2).values
            margins.append(float((top[0] - top[1]) / lg.abs().max()))
            toks.append(int(lg.argmax()))
            p = p_old if i < 4 else p_new
            lg, cache = TF.decode_step(cfg, p, cache, torch.tensor(
                [[toks[-1]]], device="cuda"), len(prompt) + i)
            lg = lg[0, 0]
        _near_tie_equal(done[rid], toks, margins)


def _neg(tree):
    if isinstance(tree, dict):
        return {k: _neg(v) for k, v in tree.items()}
    return -tree


# ---------------------------------------------------------------------------
# the training path: B6's and B7's backward kernels, and the loss gradient
# ---------------------------------------------------------------------------

# (B, H, Hkv, S, D, window): the launcher's train shape, a ragged S with a
# window, D = 64 and 80, S = 5, S one past a tile, groups 1, 2 and 8;
# D = 96 at phi-3-vision-4.2b's gradient shape
FLASH_BWD_CASES = [(2, 16, 8, 128, 128, 0), (1, 16, 8, 200, 128, 64),
                   (2, 8, 4, 300, 64, 0), (1, 8, 8, 256, 80, 0),
                   (2, 4, 4, 5, 64, 0), (1, 16, 2, 65, 128, 0),
                   (1, 8, 1, 129, 128, 100), (2, 32, 32, 704, 96, 0)]
# (B, S, H, K, log-decay range): rwkv6-7b's train shape, S around one
# chunk, K = 32, w down to e^-3 where the clamps bite
WKV_BWD_CASES = [(2, 128, 64, 64, 1.0), (2, 128, 64, 64, 3.0),
                 (2, 1, 8, 64, 1.0), (2, 63, 8, 64, 1.0),
                 (2, 65, 8, 64, 3.0), (2, 130, 8, 32, 1.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,S,D,win", FLASH_BWD_CASES)
def test_flash_attention_backward_kernel_matches_plain_gradient(
        B, H, Hkv, S, D, win):
    """Through the autograd Function on the model's strided views: one
    forward launch (the output bit-equal to the serve launch's), one
    backward call within 1e-4 of autograd of the plain version; a second
    backward gives the same bits."""
    need_card()
    q, k, v, dO = (_bshd(B, S, h, D, i, torch.float32)
                   for i, h in enumerate((H, Hkv, Hkv, H)))
    ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
    ops.reset_launches()
    o = fa_kern.FlashAttentionFn.apply(*ins, win)
    got = torch.autograd.grad(o, ins, dO)
    assert ops.launches()["flash_attention"] == 1
    assert ops.launches()["flash_attention_bwd"] == 1
    assert torch.equal(o, fa_kern.flash_attention(q, k, v, win))
    want = ref.flash_attention_grads_ref(q, k, v, dO, win)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.stride() == t.stride()
        close(g, w, 1e-4)
    _, lse = fa_kern.flash_attention_lse(q, k, v, win)
    again = fa_kern.flash_attention_bwd(q, k, v, o.detach(), lse, dO, win)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def flash_bwd_tol(S):
    """The backward's limit, relative to each gradient's largest |plain|:
    2e-5 + 2e-8 per key a row sums over, at most 1e-4 (chip_smoke.py)."""
    return min(1e-4, 2e-5 + 2e-8 * S)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 80, 96, 128])
@pytest.mark.parametrize("win", [0, 48])
@pytest.mark.parametrize("S", [211, 1000])
def test_flash_attention_backward_at_every_head_dim(D, win, S):
    """The wgmma backward at each head dimension, causal and windowed, at
    S not a multiple of the streamed tile (16) nor of a CTA's rows (128),
    GQA groups of 2: dq, dk, dv under the per-S limit, a second launch
    the same bits, one backward launch."""
    need_card()
    B, H, Hkv = 2, 8, 4
    q, k, v, dO = (_bshd(B, S, h, D, i + D, torch.float32)
                   for i, h in enumerate((H, Hkv, Hkv, H)))
    o, lse = fa_kern.flash_attention_lse(q, k, v, win)
    ops.reset_launches()
    got = fa_kern.flash_attention_bwd(q, k, v, o, lse, dO, win)
    assert ops.launches()["flash_attention_bwd"] == 1
    again = fa_kern.flash_attention_bwd(q, k, v, o, lse, dO, win)
    want = ref.flash_attention_grads_ref(q, k, v, dO, win)
    for g, w in zip(got, want):
        close(g, w, flash_bwd_tol(S))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_flash_attention_backward_copies_a_do_it_cannot_read():
    need_card()
    q, k, v = (_bshd(1, 70, h, 64, i, torch.float32)
               for i, h in enumerate((4, 2, 2)))
    dO = _bshd(1, 70, 4, 128, 7, torch.float32)[..., ::2]
    assert dO.stride(-1) == 2
    o, lse = fa_kern.flash_attention_lse(q, k, v)
    ops.reset_launches()
    got = fa_kern.flash_attention_bwd(q, k, v, o, lse, dO)
    assert ops.copies()["flash_attention_bwd.dO"] == 1
    want = fa_kern.flash_attention_bwd(q, k, v, o, lse, dO.contiguous())
    assert ops.copies()["flash_attention_bwd.dO"] == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(TypeError, match="float32 only"):
        fa_kern.FlashAttentionFn.apply(*(t.bfloat16() for t in (q, k, v)))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,K,decay", WKV_BWD_CASES)
def test_wkv6_seq_backward_kernel_matches_plain_gradient(B, S, H, K, decay):
    """Through the autograd Function from a nonzero state, with and
    without a gradient on the final state: one launch each way, within
    2e-5 of autograd of the plain version, the forward bit-equal to the
    serve launch, a second backward the same bits."""
    need_card()
    r, k, v, w, u, S0 = _wkv_case(B, H, S, K, decay, seed=S)
    r, k, v, w = (x.transpose(1, 2).contiguous() for x in (r, k, v, w))
    g = torch.Generator(device="cuda").manual_seed(1)
    dy = torch.randn(B, S, H, K, generator=g, device="cuda")
    dSf = torch.randn(B, H, K, K, generator=g, device="cuda")
    for dsf in (dSf, None):
        ins = [t.detach().requires_grad_(True) for t in (r, k, v, w, u, S0)]
        ops.reset_launches()
        y, S_out = wkv_kern.WKV6SeqFn.apply(*ins, 64)
        outs, grads = ((y, S_out), (dy, dsf)) if dsf is not None else (
            (y,), (dy,))
        got = torch.autograd.grad(outs, ins, grads)
        assert ops.launches()["wkv6_seq"] == 1
        assert ops.launches()["wkv6_seq_bwd"] == 1
        y_serve, S_serve = wkv_kern.wkv6_seq(r, k, v, w, u, S0, 64)
        assert torch.equal(y, y_serve) and torch.equal(S_out, S_serve)
        want = ref.wkv6_seq_grads_plain(r, k, v, w, u, S0, 64, dy, dsf)
        for a, b in zip(got, want):
            close(a, b, 2e-5)
        states = wkv_kern.chunk_states(r, 64)
        wkv_kern.wkv6_seq(r, k, v, w, u, S0, 64, states)
        again = wkv_kern.wkv6_seq_bwd(r, k, v, w, u, states, dy, dsf, 64)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_no_grad_calls_make_the_single_serve_launch(monkeypatch):
    """Under torch.no_grad (and for inputs that need no grad) ops takes
    the serve launch: no log-sum-exp, no chunk states, no Function."""
    need_card()

    def refuse(*a, **kw):
        raise AssertionError("a training forward ran")
    monkeypatch.setattr(fa_kern, "flash_attention_lse", refuse)
    monkeypatch.setattr(wkv_kern, "chunk_states", refuse)
    q, k, v = (_bshd(1, 64, h, 64, i, torch.float32).requires_grad_(True)
               for i, h in enumerate((4, 2, 2)))
    r, kk, vv, w, u, S0 = _wkv_case(1, 4, 64, 32, 1.0)
    wins = [t.transpose(1, 2).contiguous().requires_grad_(True)
            for t in (r, kk, vv, w)]
    ops.reset_launches()
    with torch.no_grad():
        o = ops.flash_attention(q, k, v)
        y, _ = ops.wkv6_seq(*wins, u, S0, 64)
    o2 = ops.flash_attention(q.detach(), k.detach(), v.detach())
    assert o.grad_fn is None and y.grad_fn is None
    assert torch.equal(o, o2)
    assert {n: c for n, c in ops.launches().items() if c} == {
        "flash_attention": 2, "wkv6_seq": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_gradient_on_the_card_matches_the_cpu(arch, remat):
    """Reduced config, one worker's batch of 2 x 80 tokens: the loss
    within 1e-5 and every parameter's gradient within 1e-4 of its
    largest |g|, one forward launch per layer (two with remat) and one
    backward launch per layer; the loss equals the no_grad loss."""
    need_card()
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMWorkerPipeline
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    cfg = get_config(arch).reduced()
    p_cpu = PM.init_params(TF.param_defs(cfg),
                           torch.Generator().manual_seed(0))
    toks = LMWorkerPipeline(cfg, 1, 2, 80, seed=1).batch(0)["tokens"][0]
    out = {}
    for dev in ("cpu", "cuda"):
        params = _to(p_cpu, dev)
        leaves = _flat(params)
        for t in leaves.values():
            t.requires_grad_(True)
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        ops.reset_launches()
        loss, _ = TF.loss_fn(cfg, params, batch, remat=remat)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        launched = {n: c for n, c in ops.launches().items() if c}
        with torch.no_grad():
            ng, _ = TF.loss_fn(cfg, params, batch)
        assert torch.equal(loss.detach(), ng)
        out[dev] = (loss.detach().cpu(), dict(zip(leaves, grads)), launched)
    fwd, bwd = (("flash_attention", "flash_attention_bwd")
                if arch == "qwen3-0.6b" else ("wkv6_seq", "wkv6_seq_bwd"))
    L = cfg.n_layers
    assert out["cuda"][2] == {fwd: 2 * L if remat else L, bwd: L}
    assert out["cpu"][2] == {}
    close(out["cuda"][0], out["cpu"][0], 1e-5)
    for name, g in out["cpu"][1].items():
        close(out["cuda"][1][name], g, 1e-4)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}/{k}"))
        return out
    return {path: tree}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b"])
def test_train_step_on_the_card_matches_the_cpu(arch):
    """The BrSGD train step (training/step.py), reduced config, 8 workers
    of 2 x 32 tokens, brsgd under sign_flip at 0.25, sgd at lr 1: on the
    card and on the CPU from the same params, two steps.  The loss within
    1e-5, the same n_selected, params within 1e-4 of the largest |Δp|;
    per step 1 brsgd launch and one forward and one backward launch a
    layer per worker.  Then a guarded step with a NaN worker holds on
    both: params the input's bits, worker_ok equal."""
    need_card()
    from repro_torch.configs import (ByzantineConfig, RecoveryConfig,
                                     TrainConfig, get_config)
    from repro_torch.data.pipeline import LMWorkerPipeline
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    from repro_torch.training import build_train_step
    m = 8
    cfg = get_config(arch).reduced()
    bcfg = ByzantineConfig(attack="sign_flip", alpha=0.25)
    tcfg = TrainConfig(model=cfg, byzantine=bcfg, optimizer="sgd", lr=1.0,
                       agg_scope="global", agg_layout="gather")
    p_cpu = PM.init_params(TF.param_defs(cfg),
                           torch.Generator().manual_seed(0))
    p0 = [p.clone() for p in PM.tree_leaves(p_cpu)]
    pipe = LMWorkerPipeline(cfg, m, 2, 32, seed=1, byz=bcfg)
    fwd, bwd = (("flash_attention", "flash_attention_bwd")
                if arch == "qwen3-0.6b" else ("wkv6_seq", "wkv6_seq_bwd"))
    out = {}
    for dev in ("cpu", "cuda"):
        params = _copy(p_cpu, dev)           # the step updates in place
        bundle = build_train_step(tcfg, m, dev)
        mets = []
        for s in range(2):
            ops.reset_launches()
            params, _, met = bundle.step_fn(params, (), pipe.batch(s), s,
                                            None)
            launched = {n: c for n, c in ops.launches().items() if c}
            if dev == "cuda":
                L = cfg.n_layers
                assert launched == {"brsgd_aggregate": 1, fwd: m * L,
                                    bwd: m * L}
            mets.append(met)
        out[dev] = (mets, [p.cpu() for p in PM.tree_leaves(params)])
    (cm, cp), (gm, gp) = out["cpu"], out["cuda"]
    for c, g in zip(cm, gm):
        assert abs(g["loss"] - c["loss"]) <= 1e-5 * abs(c["loss"])
        assert g["n_selected"] == c["n_selected"]
    dp = max(float((q - p).abs().max()) for q, p in zip(cp, p0))
    err = max(float((q - p).abs().max()) for q, p in zip(gp, cp))
    assert err <= 1e-4 * dp, (err, dp)

    guarded = TrainConfig(model=cfg, byzantine=ByzantineConfig(
        attack="sign_flip", alpha=0.25, max_m=m, quorum=m), optimizer="sgd",
        agg_scope="global", recovery=RecoveryConfig(guard=True))
    flt = np.zeros(m, np.float32)
    flt[5] = 1
    oks = []
    for dev in ("cpu", "cuda"):
        params = _copy(p_cpu, dev)
        before = [p.clone() for p in PM.tree_leaves(params)]
        bundle = build_train_step(guarded, m, dev)
        params, _, met = bundle.step_fn(params, (), pipe.batch(0), 0, None,
                                        None, flt)
        assert met["step_ok"] == 0.0
        assert all(torch.equal(a, b) for a, b in
                   zip(before, PM.tree_leaves(params)))
        oks.append(met["worker_ok"])
    np.testing.assert_array_equal(oks[0], oks[1])
    assert oks[0][5] == 0 and oks[0].sum() == m - 1


def _copy(tree, dev):
    if isinstance(tree, dict):
        return {k: _copy(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


@pytest.mark.gpu
def test_brsgd_launch_past_2_31_elements():
    """G [20, 120,000,000]: 2.4e9 elements, past 2^31, and score counts
    past 2^24.  The fused brsgd launch against plain statistics summed
    over column blocks of 2^22: scores exact (the blocks' whole counts
    summed in float64), l1 within 1e-5; its selection and 𝔗 the plain
    rule's on its own statistics; its aggregate bit-equal to
    masked_mean_det on the first, a middle and the last block; B3 and
    the column pass's scores at the same G too."""
    need_card()
    m, d, blk = 20, 120_000_000, 1 << 22
    assert m * d > 2 ** 31
    G = torch.randn((m, d), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    r = kern.brsgd_aggregate(G, 0.5, 0.0)
    sc = torch.zeros(m, dtype=torch.float64, device="cuda")
    l1 = torch.zeros(m, dtype=torch.float64, device="cuda")
    for a in range(0, d, blk):
        part = ref.fused_stats_ref(G[:, a:a + blk], ("scores", "l1"))
        sc += part["scores"].double()
        l1 += part["l1"].double()
    assert float(sc.max()) > 2 ** 24
    exact(r.scores, sc.float())
    close(r.l1, l1.float())
    sel, c1, c2, T = ref.brsgd_select_mask(r.scores, r.l1, 0.5, 0.0)
    exact(r.selected, sel)
    exact(r.threshold, T)
    n = 1 << 16
    for a in (0, d // 2 + 12345, d - n):
        exact(r.agg[a:a + n], ref.masked_mean_det(G[:, a:a + n], r.w))
    w = torch.linspace(0.5, 2.0, m, device="cuda")
    mm = kern.masked_mean(G, w)
    exact(mm[d - n:], ref.masked_mean_det(G[:, d - n:], w))
    exact(kern.fused_stats(G, ("scores",))["scores"], sc.float())


# ---------------------------------------------------------------------------
# MLA: B6's and B6-bwd's (96, 64) and (192, 128) instances; the zoo
# configs on the card
# ---------------------------------------------------------------------------

def _mla_inputs(B, H, Hkv, S, dtype, seed=0, D=96, Dv=64):
    """q, k [B,H(kv),S,D], v [B,Hkv,S,Dv] and dO [B,H,S,Dv], as views of
    [B,S,H,D] data (the model's layout)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(B, S, h, d, generator=g, device="cuda")
                 .to(dtype).transpose(1, 2)
                 for h, d in ((H, D), (Hkv, D), (Hkv, Dv), (H, Dv)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,win", [(2, 40, 40, 128, 0),
                                           (1, 8, 4, 211, 0),
                                           (2, 8, 2, 300, 48),
                                           (1, 4, 4, 5, 0)])
def test_flash_attention_mla_instance_matches_plain(B, H, Hkv, S, win, dtype):
    """B6 at (D, Dv) = (96, 64): [B,H,S,64] out in q's layout, within the
    B6 limits of the plain version, one launch."""
    need_card()
    q, k, v, _ = _mla_inputs(B, H, Hkv, S, dtype, seed=S)
    ops.reset_launches()
    got = fa_kern.flash_attention(q, k, v, win)
    assert ops.launches()["flash_attention"] == 1
    assert got.shape == (B, H, S, 64) and got.stride(2) == H * 64
    want = ref.flash_attention_ref(q, k, v, win)
    rtol, atol = (2e-4, 2e-5) if dtype == torch.float32 else (1e-2, 1e-2)
    err = ((got.double() - want.double()).abs()
           - rtol * want.double().abs()).max()
    assert float(err) <= atol


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,S,win", [(2, 40, 40, 128, 0),
                                           (1, 8, 4, 211, 0),
                                           (2, 8, 2, 1000, 48),
                                           (1, 4, 4, 5, 0)])
def test_flash_attention_mla_backward_matches_plain_gradient(B, H, Hkv, S,
                                                             win):
    """B6-bwd at (96, 64) through the autograd Function: dq, dk [..96],
    dv [..64] within the per-S limit of the B6-bwd rows, one forward and
    one backward launch, a second backward the same bits."""
    need_card()
    q, k, v, dO = _mla_inputs(B, H, Hkv, S, torch.float32, seed=S + 1)
    ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
    ops.reset_launches()
    o = fa_kern.FlashAttentionFn.apply(*ins, win)
    got = torch.autograd.grad(o, ins, dO)
    assert ops.launches()["flash_attention"] == 1
    assert ops.launches()["flash_attention_bwd"] == 1
    want = ref.flash_attention_grads_ref(q, k, v, dO, win)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.stride() == t.stride()
        close(g, w, flash_bwd_tol(S))
    _, lse = fa_kern.flash_attention_lse(q, k, v, win)
    again = fa_kern.flash_attention_bwd(q, k, v, o.detach(), lse, dO, win)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,win", [(2, 128, 128, 128, 0),
                                           (1, 8, 4, 211, 0),
                                           (2, 8, 2, 300, 48),
                                           (1, 4, 4, 5, 0)])
def test_flash_attention_192_128_instance_matches_plain(B, H, Hkv, S, win,
                                                        dtype):
    """B6 at (D, Dv) = (192, 128), deepseek-v2's (float32 on 32-row key
    tiles): [B,H,S,128] out in q's layout, within the B6 limits of the
    plain version, one launch."""
    need_card()
    q, k, v, _ = _mla_inputs(B, H, Hkv, S, dtype, seed=S, D=192, Dv=128)
    ops.reset_launches()
    got = fa_kern.flash_attention(q, k, v, win)
    assert ops.launches()["flash_attention"] == 1
    assert got.shape == (B, H, S, 128) and got.stride(2) == H * 128
    want = ref.flash_attention_ref(q, k, v, win)
    rtol, atol = (2e-4, 2e-5) if dtype == torch.float32 else (1e-2, 1e-2)
    err = ((got.double() - want.double()).abs()
           - rtol * want.double().abs()).max()
    assert float(err) <= atol


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,S,win", [(2, 128, 128, 128, 0),
                                           (1, 8, 4, 211, 0),
                                           (2, 8, 2, 1000, 48),
                                           (1, 4, 4, 5, 0)])
def test_flash_attention_192_128_backward_matches_plain_gradient(
        B, H, Hkv, S, win):
    """B6-bwd at (192, 128) through the autograd Function: dq, dk [..192],
    dv [..128] within the per-S limit of the B6-bwd rows, one forward and
    one backward launch, a second backward the same bits."""
    need_card()
    q, k, v, dO = _mla_inputs(B, H, Hkv, S, torch.float32, seed=S + 1,
                              D=192, Dv=128)
    ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
    ops.reset_launches()
    o = fa_kern.FlashAttentionFn.apply(*ins, win)
    got = torch.autograd.grad(o, ins, dO)
    assert ops.launches()["flash_attention"] == 1
    assert ops.launches()["flash_attention_bwd"] == 1
    want = ref.flash_attention_grads_ref(q, k, v, dO, win)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.stride() == t.stride()
        close(g, w, flash_bwd_tol(S))
    _, lse = fa_kern.flash_attention_lse(q, k, v, win)
    again = fa_kern.flash_attention_bwd(q, k, v, o.detach(), lse, dO, win)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _mla_small_config(arch="minicpm3-4b"):
    """An MLA arch's head widths (minicpm3-4b: q/k 64 + 32, v 64;
    deepseek-v2-236b: 128 + 64, v 128) in a small model: the reduced
    config with the full attention spec at 4 heads."""
    import dataclasses
    from repro_torch.configs import get_config
    full = get_config(arch)
    return dataclasses.replace(
        full.reduced(), attention=dataclasses.replace(
            full.attention, n_heads=4, n_kv_heads=4, q_lora_rank=64,
            kv_lora_rank=32))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "nemotron-4-15b", "mla",
                                  "dbrx-132b", "deepseek-v2-236b"])
def test_zoo_config_on_the_card_matches_the_cpu(arch):
    """qwen3-1.7b, nemotron-4-15b and dbrx-132b reduced, MLA at
    minicpm3's head widths and deepseek-v2 reduced at its own (the moe
    layers route on each device alike): the prefill's logits and 4
    decode steps over a float32 cache
    within 1e-4 of max|logit|, greedy tokens equal; the loss within 1e-5
    and every leaf's gradient within 1e-4 of its largest |g|; one B6 a
    layer in the prefill, none in decode, one B6 and one B6-bwd a layer
    in the gradient."""
    need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    cfg = (_mla_small_config() if arch == "mla"
           else _mla_small_config(arch) if arch == "deepseek-v2-236b"
           else get_config(arch).reduced())
    p_cpu = PM.init_params(TF.param_defs(cfg),
                           torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 40)))
    B, S, steps, L = 2, 40, 4, cfg.n_layers
    out = {}
    for dev in ("cpu", "cuda"):
        params = _to(p_cpu, dev)
        cache = TF.init_cache(cfg, B, S + steps, torch.float32, dev)
        ops.reset_launches()
        lg, cache = TF.prefill_cache(cfg, params, toks.to(dev), cache)
        pre = {n: c for n, c in ops.launches().items() if c}
        logits, tok = [lg[:, -1].cpu()], lg[:, -1].argmax(-1)[:, None]
        ops.reset_launches()
        for i in range(steps):
            lg, cache = TF.decode_step(cfg, params, cache, tok, S + i)
            logits.append(lg[:, 0].cpu())
            tok = lg.reshape(B, -1).argmax(-1)[:, None]
        dec = {n: c for n, c in ops.launches().items() if c}
        params = _clone(_to(p_cpu, dev))   # p_cpu never requires grad
        leaves = _flat(params)
        for t in leaves.values():
            t.requires_grad_(True)
        ops.reset_launches()
        loss, _ = TF.loss_fn(cfg, params, {"tokens": toks.to(dev)})
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grad_launches = {n: c for n, c in ops.launches().items() if c}
        out[dev] = (logits, loss.detach().cpu(), dict(zip(leaves, grads)),
                    pre, dec, grad_launches)
    assert out["cuda"][3:] == ({"flash_attention": L}, {},
                               {"flash_attention": L,
                                "flash_attention_bwd": L})
    for g, w in zip(out["cuda"][0], out["cpu"][0]):
        close(g, w, 1e-4)
        exact(g.argmax(-1), w.argmax(-1))
    close(out["cuda"][1], out["cpu"][1], 1e-5)
    for name, g in out["cpu"][2].items():
        close(out["cuda"][2][name], g, 1e-4)


def _blocked_round_recorder(monkeypatch):
    """Every ``BlockedRound`` the blocked step makes, kept for the test."""
    from repro_torch.core import blocked
    rounds = []

    class Recording(blocked.BlockedRound):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rounds.append(self)
    monkeypatch.setattr(blocked, "BlockedRound", Recording)
    return rounds


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b", "dbrx-132b",
                                  "zamba2-2.7b"])
def test_blocked_step_on_the_card_matches_the_cpu(arch, monkeypatch):
    """The blocked scope (``agg_scope="blocked"``, remat), reduced config,
    8 workers of 2 x 32 tokens, brsgd under sign_flip at 0.25, sgd at lr
    1, on the card and on the CPU from the same params, two steps: every
    bucket's selection and n_selected exact, the loss within 1e-5, params
    within 1e-4 of the largest |Δp|; on the card one brsgd launch a
    bucket (a layer, a hybrid unit, the top) and two forward launches
    (remat) and one backward launch an attention application (a layer
    for rwkv) a worker; on both, the layer-major backward's lockstep: the
    rows of the top bucket and of one layer bucket live at most."""
    need_card()
    from repro_torch.configs import ByzantineConfig, TrainConfig, get_config
    from repro_torch.core import blocked
    from repro_torch.data.pipeline import LMWorkerPipeline
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    from repro_torch.training import build_train_step
    rounds = _blocked_round_recorder(monkeypatch)
    sels = []
    agg_rows = blocked.aggregate_rows

    def record(rows, bcfg, valid=None):
        agg, st = agg_rows(rows, bcfg, valid)
        sels.append(st.selected.cpu())
        return agg, st
    monkeypatch.setattr(blocked, "aggregate_rows", record)
    m = 8
    cfg = get_config(arch).reduced()
    bcfg = ByzantineConfig(attack="sign_flip", alpha=0.25)
    tcfg = TrainConfig(model=cfg, byzantine=bcfg, optimizer="sgd", lr=1.0,
                       agg_scope="blocked", remat="block")
    p_cpu = PM.init_params(TF.param_defs(cfg),
                           torch.Generator().manual_seed(0))
    p0 = [p.clone() for p in PM.tree_leaves(p_cpu)]
    pipe = LMWorkerPipeline(cfg, m, 2, 32, seed=1, byz=bcfg)
    segs = TF.segments(cfg)
    n_b = sum(s.n for s in segs) + 1
    apps = sum(s.n for s in segs)            # a layer, or a unit's shared block
    fwd, bwd = (("wkv6_seq", "wkv6_seq_bwd") if arch == "rwkv6-7b"
                else ("flash_attention", "flash_attention_bwd"))
    out = {}
    for dev in ("cpu", "cuda"):
        params = _copy(p_cpu, dev)
        bundle = build_train_step(tcfg, m, dev)
        mets, start = [], len(sels)
        for s in range(2):
            ops.reset_launches()
            params, _, met = bundle.step_fn(params, (), pipe.batch(s), s,
                                            None)
            launched = {n: c for n, c in ops.launches().items() if c}
            if dev == "cuda":
                assert launched == {"brsgd_aggregate": n_b,
                                    fwd: 2 * m * apps, bwd: m * apps}
            rnd = rounds[-1]
            assert len(rnd.calls) == n_b and rnd.live == set()
            assert len(rnd.peak_live) == 2 and ("top", 0) in rnd.peak_live
            mets.append(met)
        out[dev] = (mets, sels[start:],
                    [p.cpu() for p in PM.tree_leaves(params)])
    (cm, cs, cp), (gm, gs, gp) = out["cpu"], out["cuda"]
    assert len(cs) == len(gs) == 2 * n_b
    assert all(torch.equal(a, b) for a, b in zip(cs, gs))
    for c, g in zip(cm, gm):
        assert abs(g["loss"] - c["loss"]) <= 1e-5 * abs(c["loss"])
        assert g["n_selected"] == c["n_selected"]
        assert g["n_selected_min"] == c["n_selected_min"]
    dp = max(float((q - p).abs().max()) for q, p in zip(cp, p0))
    err = max(float((q - p).abs().max()) for q, p in zip(gp, cp))
    assert err <= 1e-4 * dp, (err, dp)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fixed", "elastic"])
@pytest.mark.parametrize("rule", ["brsgd", "geomedian", "krum", "mean",
                                  "median", "multi_krum", "trimmed_mean"])
def test_bucket_aggregate_on_the_card_matches_the_cpu(rule, mode):
    """``core.blocked._bucket_aggregate`` on one [8, ...] bucket tree (a
    leaf of 2·8·6, one of 7, one of 6 columns), on the card (one launch
    for a fixed round; the masked round and its combine for an elastic
    one) and on the CPU: the selection exact, the aggregate within 1e-5
    of its largest magnitude (geomedian's weights within 1e-5)."""
    need_card()
    from repro_torch.configs import ByzantineConfig
    from repro_torch.core import blocked
    rng = np.random.default_rng(3)
    m = 8
    tree = {"w": rng.normal(size=(m, 2 * m, 6)), "b": rng.normal(size=(m, 7)),
            "u": rng.normal(size=(m, m - 2))}
    tree = {k: torch.from_numpy(v.astype(np.float32)) for k, v in tree.items()}
    tree = {k: v * torch.where(torch.arange(m) < m // 4, -4.0, 1.0).reshape(
        (m,) + (1,) * (v.dim() - 1)) for k, v in tree.items()}
    kw = {"max_m": m, "quorum": 6} if mode == "elastic" else {}
    bcfg = ByzantineConfig(aggregator=rule, alpha=0.25, **kw)
    valid = (torch.tensor([1, 1, 0, 1, 1, 1, 0, 1], dtype=torch.float32)
             if mode == "elastic" else None)
    want, wst = blocked._bucket_aggregate(tree, bcfg, valid)
    ops.reset_launches()
    got, gst = blocked._bucket_aggregate(
        {k: v.cuda() for k, v in tree.items()}, bcfg,
        None if valid is None else valid.cuda())
    if mode == "fixed":
        assert sum(ops.launches().values()) == 1, ops.launches()
    exact(gst.selected, wst.selected)
    for k in tree:
        close(got[k], want[k])


@pytest.mark.gpu
def test_blocked_guarded_step_holds_on_the_card():
    """A guarded blocked step (quorum 8 of 8) with a NaN on worker 5
    holds on the card as on the CPU: params the input's bits, worker_ok
    equal, step_ok 0; then with worker 5 inactive both take the step
    with the same n_selected."""
    need_card()
    from repro_torch.configs import (ByzantineConfig, RecoveryConfig,
                                     TrainConfig, get_config)
    from repro_torch.data.pipeline import LMWorkerPipeline
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as TF
    from repro_torch.training import build_train_step
    m = 8
    cfg = get_config("qwen3-0.6b").reduced()
    tcfg = TrainConfig(model=cfg, byzantine=ByzantineConfig(
        attack="sign_flip", alpha=0.25, max_m=m, quorum=m), optimizer="sgd",
        agg_scope="blocked", recovery=RecoveryConfig(guard=True))
    p_cpu = PM.init_params(TF.param_defs(cfg),
                           torch.Generator().manual_seed(0))
    pipe = LMWorkerPipeline(cfg, m, 2, 32, seed=1)
    flt = np.zeros(m, np.float32)
    flt[5] = 1
    act = np.ones(m, np.float32)
    act[5] = 0
    out = []
    for dev in ("cpu", "cuda"):
        params = _copy(p_cpu, dev)
        before = [p.clone() for p in PM.tree_leaves(params)]
        bundle = build_train_step(tcfg, m, dev)
        params, _, met = bundle.step_fn(params, (), pipe.batch(0), 0, None,
                                        None, flt)
        assert met["step_ok"] == 0.0
        assert all(torch.equal(a, b) for a, b in
                   zip(before, PM.tree_leaves(params)))
        params, _, met2 = bundle.step_fn(params, (), pipe.batch(1), 1, None,
                                         act, flt)
        assert met2["step_ok"] == 1.0 and met2["n_active"] == m - 1
        out.append((met["worker_ok"], met2["n_selected"],
                    met2["n_selected_min"]))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][0][5] == 0 and out[0][0].sum() == m - 1
    assert out[0][1:] == out[1][1:]


# ---------------------------------------------------------------------------
# the torch.distributed layouts: 4 gloo ranks on the card against 4 CPU
# ranks (tests/torch_dist_ranks.py; the CPU ranks are held against the JAX
# package in tests/test_torch_distributed.py)
# ---------------------------------------------------------------------------

_DIST_TRAIN = ("flat_gather", "flat_a2a", "dm_a2a")


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    """(inputs, the card's rank outputs, the CPU's rank outputs) of the
    engine matrix, the deterministic attacks and three train steps."""
    need_card()
    import torch_dist_ranks as R
    from repro_torch.launch import mesh as MM
    out = {}
    d = tmp_path_factory.mktemp("dist_gpu")
    inp = R.make_inputs(str(d / "inputs.npz"))
    for dev, threads in (("cuda", 0), ("cpu", 2)):
        sub = d / dev
        sub.mkdir()
        paths = MM.launch(R.run_cases, 4, (str(d / "inputs.npz"), str(sub),
                                           dev, ("engine", "inject",
                                                 "train"), _DIST_TRAIN),
                          device=dev, threads=threads, timeout_s=900)
        out[dev] = [dict(np.load(p)) for p in paths]
    return inp, out["cuda"], out["cpu"]


def _dist_engine_cases():
    import torch_dist_ranks as R
    from repro_torch.core import engine
    return [(n, lay, el, r) for n in R.MESHES for lay in R.LAYOUTS
            for el in (False, True) for r in engine.registered()]


@pytest.mark.gpu
@pytest.mark.parametrize("case", _dist_engine_cases(),
                         ids=lambda c: f"{c[0]}-{c[1]}-{int(c[2])}-{c[3]}")
def test_aggregate_sharded_on_the_card_matches_cpu_ranks(case, dist_runs):
    """Every rule in gather, a2a and the mixed plan, fixed and elastic,
    on CUDA tensors (the statistics on the kernels, every collective's
    tensor on the card) against the same ranks on the CPU: selections
    and scores exact, aggregates within 1e-6 of max|agg|, the same
    all_gather / all_to_all counts."""
    import torch_dist_ranks as R
    _inp, card, cpu = dist_runs
    name, layout, elastic, rule = case
    key = f"{name}/{layout}/{int(elastic)}/{rule}"
    for r in range(4):
        for k in R.LEAVES:
            g, c = card[r][f"{key}/agg/{k}"], cpu[r][f"{key}/agg/{k}"]
            scale = max(float(np.abs(c).max()), 1e-30)
            assert float(np.abs(g - c).max()) <= 1e-6 * scale, (key, r, k)
        for sk in R.state_keys(rule, elastic):
            if sk in ("selected", "scores"):
                np.testing.assert_array_equal(card[r][f"{key}/st/{sk}"],
                                              cpu[r][f"{key}/st/{sk}"])
        np.testing.assert_array_equal(card[r][f"{key}/collectives"],
                                      cpu[r][f"{key}/collectives"])
        assert list(card[r][f"{key}/device_types"]) in ([], ["cuda"])


@pytest.mark.gpu
@pytest.mark.parametrize("case", _DIST_TRAIN)
def test_reduced_step_on_four_card_ranks_matches_cpu_ranks(case,
                                                           dist_runs):
    """The reduced qwen3's global step with one rank a worker, 2 steps,
    on 4 ranks on the card against 4 CPU ranks from the same params and
    tokens: n_selected equal, params within 1e-5 of the largest |Δp|."""
    import torch_dist_ranks as R
    inp, card, cpu = dist_runs
    name, layout, guard = R.train_cases()[case]
    from repro_torch.models import transformer as TF
    paths = R.tree_paths(TF.param_defs(R.train_config(name, layout,
                                                      guard).model))
    before = [inp["params" + p] for p in paths]
    for s in range(R.STEPS):
        key = f"train/{case}/{s}"
        assert float(card[0][f"{key}/met/n_selected"]) == float(
            cpu[0][f"{key}/met/n_selected"])
        got = [card[0][f"{key}/params{p}"] for p in paths]
        want = [cpu[0][f"{key}/params{p}"] for p in paths]
        dp = max(float(np.abs(w - b).max()) for w, b in zip(want, before))
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        assert dp > 0 and err <= 1e-5 * dp, (key, err, dp)
        before = want
