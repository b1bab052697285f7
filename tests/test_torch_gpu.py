"""The CUDA kernels on the card against their plain PyTorch versions on
the same tensors, and one card step against one CPU step.  Every test
is marked ``gpu`` and skips inside the test where no card is present.
This file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: scores, weights, medians, trimmed means and the row-order
combines exact; l1/d2med/gram within 1e-5 of the largest finite
reference magnitude.  NaN must sit where the plain version has it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import brsgd_stats as kern
from repro_torch.kernels import ops, ref

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
                             "trimmed_mean": 0}
    with pytest.raises(ValueError, match="no kernel instance"):
        kern.fused_stats(torch.zeros(6, 10, device="cuda"), ("l1",))
    with pytest.raises(TypeError):
        kern.masked_mean(G.double(), torch.ones(20, device="cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        kern.brsgd_stats(G.T.contiguous().T)
    with pytest.raises(ValueError, match="thresholds"):
        kern.select_mean(G, torch.zeros(20, device="cuda"),
                         torch.zeros(20, device="cuda"),
                         torch.tensor(0.0), torch.tensor(1.0))


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
