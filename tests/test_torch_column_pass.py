"""The column pass (``column_stats_kernel``: B1 without gram, B4 and the
median alone): its launch plan and C interface, which need no card, and
the CPU dispatch of the median against ``cwise_median_pallas`` in
interpret mode on the same numpy inputs.

Tolerances: medians exact (NaN where the Pallas kernel has it).  The
kernel itself is held against its plain versions in test_torch_gpu.py.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.brsgd_stats import cwise_median_pallas
from repro_torch.kernels import _build, ops
from repro_torch.kernels import brsgd_stats as kern

# B1's (scores, l1) call, B4, the median alone
VARIANTS = (kern.NEED_BITS["scores"] | kern.NEED_BITS["l1"], kern.B4_VARIANT,
            kern.COLUMN_OUT)
LIMIT = kern.SMEM_BLOCK_LIMIT - kern.AGG_STATIC_SMEM


def h100_blocks(smem):
    """Co-resident blocks of a card like the H100 as a function of each
    block's dynamic shared memory: 132 SMs of 228 KB, 1 KB of it kept by
    the system per block, at most 8 blocks an SM (registers)."""
    return 132 * min(8, 233472 // (smem + 3 * 1024 + 1024))


@pytest.mark.parametrize("m", kern.TUNED_M)
@pytest.mark.parametrize("d", [20, 1003, 61706, 8_388_608])
def test_column_plan_fits_a_block_and_keeps_loads_in_flight(m, d):
    n_tiles = -(-d // kern.THREADS)
    stage = 4 * m * kern.RING_LD
    for variant in VARIANTS:
        plan = kern.column_plan(m, d, variant, h100_blocks)
        assert 2 <= plan.stages <= kern.MAX_STAGES
        # the stages in flight while one is read: 32 KB, or all it may have
        assert ((plan.stages - 1) * stage >= kern.IN_FLIGHT_BYTES
                or plan.stages == kern.MAX_STAGES)
        assert plan.stages == 2 or (plan.stages - 2) * stage \
            < kern.IN_FLIGHT_BYTES
        assert plan.smem == kern.column_smem(m, variant, plan.stages) <= LIMIT
        assert plan.grid == min(n_tiles, h100_blocks(plan.smem)) >= 1
        sort = 4 * 64 * kern.THREADS if m == 64 else 0   # each takes a median
        assert plan.smem == sort + plan.stages * stage


def test_column_plan_at_every_worker_count():
    """Every m in 1..64, tuned or bucket: the ring of [m, RING_LD] stages
    and, where m's instance has 64 rows and takes a median, the sort
    columns of its power of two; within a block and on the card."""
    for m in range(1, kern.MAX_M + 1):
        stage = 4 * m * kern.RING_LD
        for d in (61, 1003, 61706, 8_388_608):
            n_tiles = -(-d // kern.THREADS)
            for variant in VARIANTS:
                plan = kern.column_plan(m, d, variant, h100_blocks)
                assert plan.stages == kern.column_stages(m)
                assert 2 <= plan.stages <= kern.MAX_STAGES
                # each variant takes a median; 33..63 run the 64-row bucket
                sort = 4 * 64 * kern.THREADS if m > 32 else 0
                assert plan.smem == sort + plan.stages * stage <= LIMIT
                assert plan.grid == min(n_tiles, h100_blocks(plan.smem)) >= 1


def test_column_plan_at_the_paper_shapes():
    """m = 20: four stages of [20, 132] floats (42,240 bytes, three in
    flight); one block a tile at [20, 61706], a persistent grid of every
    co-resident block at [20, 8388608]."""
    plan = kern.column_plan(20, 61706, kern.COLUMN_OUT, h100_blocks)
    assert plan == kern.ColumnPlan(483, 4, 4 * 4 * 20 * 132)
    plan = kern.column_plan(20, 8_388_608, kern.B4_VARIANT, h100_blocks)
    assert plan == kern.ColumnPlan(132 * 5, 4, 42240)
    # m = 64: two stages and the sort columns, 100 KB a block
    plan = kern.column_plan(64, 8_388_608, kern.COLUMN_OUT, h100_blocks)
    assert plan == kern.ColumnPlan(132 * 2, 2, 4 * (64 * 128 + 2 * 64 * 132))
    with pytest.raises(RuntimeError, match="no block"):
        kern.column_plan(20, 61706, kern.COLUMN_OUT, lambda smem: 0)


@pytest.mark.parametrize("n_tiles",
                         [1, 2 ** 16 - 1, 2 ** 16, 3 * (2 ** 16 - 1) + 1])
def test_column_plan_keeps_a_blocks_tiles_below_its_count_planes(n_tiles):
    """A score count per thread has COUNT_PLANES bits: however few blocks
    the card holds at once, none takes 2^16 tiles (the kernel refuses
    such a grid)."""
    d = kern.THREADS * (n_tiles - 1) + 3
    plan = kern.column_plan(4, d, 1, lambda smem: 1)
    assert -(-n_tiles // plan.grid) < 2 ** kern.COUNT_PLANES
    assert plan.grid == max(1, -(-n_tiles // (2 ** kern.COUNT_PLANES - 1)))


def test_column_constants_match_the_cuda_source():
    src = _build.expanded_source()
    for name in ("COLUMN_OUT", "MAX_STAGES", "COUNT_PLANES"):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == getattr(kern, name), name
    found = re.search(r"constexpr int RING_LD = THREADS \+ (\d+);", src)
    assert found and kern.RING_LD == kern.THREADS + int(found.group(1))
    assert "cp.async.cg.shared.global" in src
    # the column pass's instances: B1's seven needs without gram, B4 and
    # the median alone
    cases = re.search(r"#define COLUMN_DISPATCH.*?default:", src, re.S)
    assert cases
    assert len(re.findall(r"constexpr int V = ", cases.group(0))) == 9


def _extern_c_entries(src: str) -> dict:
    """{name: parameter count} of every int-returning function of the
    extern "C" block."""
    block = src[src.index('extern "C" {'):]
    out = {}
    for name, params in re.findall(r"^int (\w+)\(([^)]*)\)", block, re.M):
        out[name] = len([p for p in params.split(",") if p.strip()])
    return out


def test_every_c_entry_is_declared_with_its_arity():
    """Every entry of _build.SIGNATURES is defined in the extern "C"
    block with as many parameters, the median's own among them."""
    entries = _extern_c_entries(_build.expanded_source())
    sig = _build.SIGNATURES["brsgd_stats"]
    assert {"brsgd_cwise_median", "brsgd_column_coresident",
            "brsgd_column_stats", "brsgd_fused_stats"} <= set(sig)
    for name, args in sig.items():
        assert entries.get(name) == len(args), name
    assert set(entries) == set(sig)
    assert sig["brsgd_cwise_median"] == (
        _build.ctypes.c_void_p, _build.ctypes.c_int, _build.ctypes.c_longlong,
        _build.ctypes.c_void_p, _build.ctypes.c_int, _build.ctypes.c_int,
        _build.ctypes.c_void_p)


@pytest.mark.parametrize("m", kern.TUNED_M)
@pytest.mark.parametrize("where", ["none", "row", "columns"])
def test_cwise_median_matches_pallas(m, where):
    """ops.cwise_median on the CPU (the plain version the kernel is held
    to) equals cwise_median_pallas in interpret mode, at d % 4 != 0, with
    a NaN worker or NaN columns."""
    d = 203
    G = np.random.default_rng(m).normal(size=(m, d)).astype(np.float32)
    if where == "row":
        G[m // 3] = np.nan
    elif where == "columns":
        cols = np.arange(0, d, 7)
        G[cols % m, cols] = np.nan
    got = ops.cwise_median(torch.from_numpy(G))
    want = np.asarray(cwise_median_pallas(jnp.asarray(G), d_blk=64))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want).any() == (where != "none")


def test_column_wrappers_refuse_cpu_tensors_and_count_nothing():
    kern.reset_launches()
    G = torch.zeros(20, 50)
    for call in (lambda: kern.cwise_median(G), lambda: kern.brsgd_stats(G),
                 lambda: kern.fused_stats(G, ("l1",)),
                 lambda: kern.column_launch_plan(G, kern.COLUMN_OUT)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert set(kern.LAUNCHES.values()) == {0}
    assert "cwise_median" in kern.LAUNCHES
