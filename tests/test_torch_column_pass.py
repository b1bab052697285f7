"""The column pass (``column_stats_kernel``: B1 without gram, B4, the
median alone and B5, the trimmed mean): its launch plan and C interface,
which need no card, and the CPU dispatch of the median and of the
trimmed mean against ``cwise_median_pallas`` / ``trimmed_mean_pallas``
in interpret mode and the JAX plain reference on the same numpy inputs.

Tolerances: medians exact (NaN where the Pallas kernel has it).  The
trimmed mean: exact against the JAX plain reference below m = 33; within
1 ulp of the Pallas kernel, which divides by a Python int that XLA turns
into a multiply by its reciprocal, and exact where m - 2k is a power of
two (as test_torch_registry.py states).  From m = 33 on the JAX plain
reference sums the sorted stack with jnp.sum (src/repro/kernels/ref.py,
_TRIM_STACK_MIN_M), another order, so there the port is held to the
Pallas kernel, which sums the sorted rows in row order as the port does,
and to the JAX reference only in where it is NaN and ±inf.  The kernel
itself is held against its plain versions in test_torch_gpu.py.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.brsgd_stats import cwise_median_pallas, trimmed_mean_pallas
from repro_torch.kernels import _build, ops
from repro_torch.kernels import brsgd_stats as kern

# B1's (scores, l1) call, B4, the median alone, the trimmed mean
VARIANTS = (kern.NEED_BITS["scores"] | kern.NEED_BITS["l1"], kern.B4_VARIANT,
            kern.COLUMN_OUT, kern.TRIM_OUT)
LIMIT = kern.SMEM_BLOCK_LIMIT - kern.AGG_STATIC_SMEM
TRIM_FRACS = (0.1, 0.25, 0.49, 0.5)     # 0.5 takes trim_k's 2k >= m guard


def h100_blocks(smem):
    """Co-resident blocks of a card like the H100 as a function of each
    block's dynamic shared memory: 132 SMs of 228 KB, 1 KB of it kept by
    the system per block, at most 8 blocks an SM (registers)."""
    return 132 * min(8, 233472 // (smem + 3 * 1024 + 1024))


def sort_bytes(m, variant):
    """The sort columns a plan holds: 64 slots a thread, only on a 64-row
    instance and only for a variant that takes a median (the trimmed mean
    sorts in registers)."""
    rows = kern.instance_rows(m)
    return 4 * 64 * kern.THREADS \
        if rows == 64 and variant != kern.TRIM_OUT else 0


@pytest.mark.parametrize("m", kern.TUNED_M)
@pytest.mark.parametrize("d", [20, 1003, 61706, 8_388_608])
def test_column_plan_fits_a_block_and_keeps_loads_in_flight(m, d):
    n_tiles = -(-d // kern.THREADS)
    stage = 4 * m * kern.RING_LD
    for variant in VARIANTS:
        plan = kern.column_plan(m, d, variant, h100_blocks)
        if variant == kern.TRIM_OUT:
            # its stages refill as soon as read: TRIM_STAGES at every m
            assert plan.stages == kern.TRIM_STAGES
        else:
            assert 2 <= plan.stages <= kern.MAX_STAGES
            # the stages in flight while one is read: 32 KB, or all it
            # may have
            assert ((plan.stages - 1) * stage >= kern.IN_FLIGHT_BYTES
                    or plan.stages == kern.MAX_STAGES)
            assert plan.stages == 2 or (plan.stages - 2) * stage \
                < kern.IN_FLIGHT_BYTES
        assert plan.smem == kern.column_smem(m, variant, plan.stages) <= LIMIT
        assert plan.grid == min(n_tiles, h100_blocks(plan.smem)) >= 1
        assert plan.smem == sort_bytes(m, variant) + plan.stages * stage


def test_column_plan_at_every_worker_count():
    """Every m in 1..64, tuned or bucket: the ring of [m, RING_LD] stages
    and, where m's instance has 64 rows and sorts in shared memory, the
    sort columns of its power of two; within a block and on the card."""
    for m in range(1, kern.MAX_M + 1):
        stage = 4 * m * kern.RING_LD
        for d in (61, 1003, 61706, 8_388_608):
            n_tiles = -(-d // kern.THREADS)
            for variant in VARIANTS:
                plan = kern.column_plan(m, d, variant, h100_blocks)
                assert plan.stages == kern.column_stages(m, variant)
                least = 1 if variant == kern.TRIM_OUT else 2
                assert least <= plan.stages <= kern.MAX_STAGES
                # 33..63 run the 64-row bucket
                assert plan.smem == sort_bytes(m, variant) + \
                    plan.stages * stage <= LIMIT
                assert plan.grid == min(n_tiles, h100_blocks(plan.smem)) >= 1


def test_column_plan_at_the_paper_shapes():
    """m = 20: four stages of [20, 132] floats (42,240 bytes, three in
    flight); one block a tile at [20, 61706], a persistent grid of every
    co-resident block at [20, 8388608].  The trimmed mean: TRIM_STAGES
    stages of the same ring, each in flight while a column sorts."""
    plan = kern.column_plan(20, 61706, kern.COLUMN_OUT, h100_blocks)
    assert plan == kern.ColumnPlan(483, 4, 4 * 4 * 20 * 132)
    plan = kern.column_plan(20, 8_388_608, kern.B4_VARIANT, h100_blocks)
    assert plan == kern.ColumnPlan(132 * 5, 4, 42240)
    # the trimmed mean reads G through the same ring
    trim_smem = kern.TRIM_STAGES * 4 * 20 * 132
    for d in (61706, 8_388_608):
        plan = kern.column_plan(20, d, kern.TRIM_OUT, h100_blocks)
        assert plan == kern.ColumnPlan(min(-(-d // 128),
                                           h100_blocks(trim_smem)),
                                       kern.TRIM_STAGES, trim_smem)
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
    for name in ("COLUMN_OUT", "TRIM_OUT", "MAX_STAGES", "COUNT_PLANES"):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == getattr(kern, name), name
    found = re.search(r"constexpr int RING_LD = THREADS \+ (\d+);", src)
    assert found and kern.RING_LD == kern.THREADS + int(found.group(1))
    assert "cp.async.cg.shared.global" in src
    # the column pass's instances: B1's seven needs without gram, B4, the
    # median alone and the trimmed mean
    cases = re.search(r"#define COLUMN_DISPATCH.*?default:", src, re.S)
    assert cases
    assert len(re.findall(r"constexpr int V = ", cases.group(0))) == 10
    assert "case TRIM_OUT:" in cases.group(0)
    # B5 is the column pass's variant: the kernel of its own is gone
    assert not re.search(r"\btrimmed_mean_kernel\b", src)
    assert re.search(r"launch_column<M, TRIM_OUT, BUCKET>", src)


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
            "brsgd_column_stats", "brsgd_fused_stats",
            "brsgd_trimmed_mean"} <= set(sig)
    for name, args in sig.items():
        assert entries.get(name) == len(args), name
    assert set(entries) == set(sig)
    assert sig["brsgd_cwise_median"] == (
        _build.ctypes.c_void_p, _build.ctypes.c_int, _build.ctypes.c_longlong,
        _build.ctypes.c_void_p, _build.ctypes.c_int, _build.ctypes.c_int,
        _build.ctypes.c_void_p)
    # G, m, d, k, out, the plan's grid and ring stages, stream
    assert sig["brsgd_trimmed_mean"] == (
        _build.ctypes.c_void_p, _build.ctypes.c_int, _build.ctypes.c_longlong,
        _build.ctypes.c_int, _build.ctypes.c_void_p, _build.ctypes.c_int,
        _build.ctypes.c_int, _build.ctypes.c_void_p)


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


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def nonfinite_columns(m, k):
    """(row, column, value) entries that make columns 0..7 of an [m, d]
    matrix non-finite in the trimmed and in the kept slots, for k rows
    trimmed a side: 0, k +inf (trimmed away); 1, k + 1 +inf (one kept:
    +inf); 2, k -inf; 3, k + 1 -inf (-inf); 4, k + 1 of each (one of each
    kept: NaN; left finite where 2k + 2 > m); 5, one NaN (NaN); 6, k +inf
    and k -inf (all trimmed); 7, all +inf."""
    def rows(col, n, v):
        return [((col + j) % m, col, v) for j in range(n)]
    ents = (rows(0, k, np.inf) + rows(1, k + 1, np.inf) + rows(2, k, -np.inf)
            + rows(3, k + 1, -np.inf) + rows(5, 1, np.nan)
            + [(col, 7, np.inf) for col in range(m)])
    # columns 4 and 6: distinct rows for the two signs
    for col, n in ((4, k + 1), (6, k)):
        if 2 * n <= m:
            ents += [(j, col, np.inf) for j in range(n)]
            ents += [(m - 1 - j, col, -np.inf) for j in range(n)]
    return ents


@pytest.mark.parametrize("m", [1, 2, 3, 12, 20, 33, 63, 64])
@pytest.mark.parametrize("trim_frac", TRIM_FRACS)
def test_trimmed_mean_matches_pallas_and_jax(m, trim_frac):
    """ops.trimmed_mean on the CPU (the plain version the kernel is held
    to) against trimmed_mean_pallas in interpret mode and the JAX plain
    reference, at the worker counts of tuned and bucket instances, with
    columns holding NaN, +inf, -inf and both, in trimmed and kept slots,
    and a d that is a multiple of neither 4 nor 128."""
    d = 203
    k = ops.ref.trim_k(trim_frac, m)
    G = np.random.default_rng(100 + m).normal(size=(m, d)).astype(np.float32)
    G[: m // 4] *= -4.0
    for i, j, v in nonfinite_columns(m, k):
        G[i, j] = v
    got = ops.trimmed_mean(torch.from_numpy(G), trim_frac).numpy()
    exact(got, ops.ref.trimmed_mean_ref(torch.from_numpy(G), trim_frac))
    pallas = np.asarray(trimmed_mean_pallas(jnp.asarray(G), trim_frac,
                                            d_blk=256))
    jax_plain = np.asarray(jref.trimmed_mean_ref(jnp.asarray(G), trim_frac))
    np.testing.assert_array_max_ulp(got, pallas, maxulp=1)
    if (m - 2 * k) & (m - 2 * k - 1) == 0:                 # a power of two
        exact(got, pallas)
    if m < 33:
        exact(got, jax_plain)
    else:
        exact(np.isnan(got), np.isnan(jax_plain))
        exact(np.where(np.isinf(got), got, 0),
              np.where(np.isinf(jax_plain), jax_plain, 0))
    # the columns whose result the placement decides
    assert np.isnan(got[5]) and got[7] == np.inf
    assert got[1] == np.inf and got[3] == -np.inf
    assert np.isnan(got[4]) == (2 * k + 2 <= m)
    assert np.isfinite(got[[0, 2, 6]]).all()


def test_column_wrappers_refuse_cpu_tensors_and_count_nothing():
    kern.reset_launches()
    G = torch.zeros(20, 50)
    for call in (lambda: kern.cwise_median(G), lambda: kern.brsgd_stats(G),
                 lambda: kern.trimmed_mean(G, 0.1),
                 lambda: kern.fused_stats(G, ("l1",)),
                 lambda: kern.column_launch_plan(G, kern.COLUMN_OUT)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert set(kern.LAUNCHES.values()) == {0}
    assert "cwise_median" in kern.LAUNCHES
