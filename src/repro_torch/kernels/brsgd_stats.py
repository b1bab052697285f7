"""Wrappers of the hand-written CUDA BrSGD kernels (``csrc/brsgd_stats.cu``).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream, raises if the launch reports an error, reduces the
per-block partials and adds one to its entry of :data:`LAUNCHES`.  The
plain versions live in :mod:`.ref`; :mod:`.ops` picks between the two
by the tensor's device.

Every worker count 1 <= m <= :data:`MAX_M` has a kernel instance: the
m of :data:`TUNED_M` a tuned one (``csrc/brsgd_stats.cu``, m a
compile-time constant), every other m the instance of its power of two
(``csrc/brsgd_bucket.cu``, m at run time; :func:`instance_rows`).  A
larger m raises.

==================  ====================================================
wrapper             replaces (src/repro/kernels/brsgd_stats.py)
==================  ====================================================
fused_stats         fused_stats_pallas (B1): without gram the column
                    pass (``column_stats_kernel``: a cp.async ring of
                    tiles, bit-sliced score counts, l1 / d2med sums in
                    registers, partials per block); with gram the gram
                    kernel; brsgd_partials is its (scores, l1) call
select_mean         select_mean_pallas (B2)
brsgd_aggregate     brsgd_partials_pallas -> ref.brsgd_thresholds ->
                    select_mean_pallas (B1's brsgd call + B2) in one
                    cooperative launch
select_aggregate    fused_stats_pallas (gram[, d2med]) -> the krum,
                    multi_krum or geomedian rule -> masked_mean_pallas
                    (B1's gram call + B3) in one cooperative launch; the
                    mean is B3 alone with unit weights
masked_mean         masked_mean_pallas (B3)
brsgd_stats         brsgd_stats_pallas (B4): the column pass writing
                    median and mean [d], scores and l1 partials
cwise_median        cwise_median_pallas: the column pass writing the
                    median [d] alone (one launch, nothing to sum)
trimmed_mean        trimmed_mean_pallas (B5): the column pass writing
                    the trimmed mean [d] alone (k at run time)
==================  ====================================================
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import ref
from ._build import load

# worker counts with a tuned instance (csrc/brsgd_stats.cu BRSGD_DISPATCH);
# every other m up to MAX_M runs its power of two's bucket instance
# (csrc/brsgd_bucket.cu)
TUNED_M = (4, 5, 7, 8, 10, 16, 20, 32, 64)
MAX_M = 64
BUCKETS = (2, 4, 8, 16, 32, 64)
NEED_BITS = {"scores": 1, "l1": 2, "d2med": 4, "gram": 8}

# launches of each kernel since the last reset_launches()
LAUNCHES = {"fused_stats": 0, "select_mean": 0, "masked_mean": 0,
            "brsgd_stats": 0, "cwise_median": 0, "trimmed_mean": 0,
            "brsgd_aggregate": 0, "select_aggregate": 0}

# the fused kernels' shared-memory budget (csrc: THREADS, SMEM_SORT_M,
# SMEM_BLOCK_LIMIT, AGG_STATIC_SMEM, GRAM_RB, GRAM_LD): the most one
# block may hold on sm_90 (227 KB), less what its static arrays keep
THREADS = 128
SMEM_SORT_M = 64
SMEM_BLOCK_LIMIT = 232448
AGG_STATIC_SMEM = 4096
GRAM_RB = 4
GRAM_LD = THREADS + 4
# the cooperative kernel's rule instances (csrc RULE_*): krum and
# multi_krum share one
RULE_IDS = {"brsgd": 0, "krum": 1, "multi_krum": 1, "geomedian": 2}
# the column pass (csrc COLUMN_OUT, TRIM_OUT, RING_LD, MAX_STAGES,
# COUNT_PLANES): an instance is B1's needs bits without gram, B4
# (COLUMN_OUT | scores | l1), the median alone (COLUMN_OUT) or the
# trimmed mean (TRIM_OUT); a ring stage holds [m, RING_LD] floats
COLUMN_OUT = 16
TRIM_OUT = 32
B4_VARIANT = COLUMN_OUT | NEED_BITS["scores"] | NEED_BITS["l1"]
RING_LD = THREADS + 4
MAX_STAGES = 4
COUNT_PLANES = 16           # a block's tiles stay below 2^COUNT_PLANES
IN_FLIGHT_BYTES = 32768     # ring bytes a block keeps in flight, at least
TRIM_STAGES = 1             # the trimmed mean's ring (see column_stages)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def instance_rows(m: int) -> int:
    """The rows M of the kernel instance that serves m workers: m itself
    for a tuned m, else its bucket, the power of two at or above it."""
    return m if m in TUNED_M else ref.padded_workers(m)


def _lib(m: int):
    """The kernel library that holds m's instance."""
    return load("brsgd_stats" if m in TUNED_M else "brsgd_bucket")


def _check_matrix(G, name: str):
    if not isinstance(G, torch.Tensor) or not G.is_cuda:
        raise ValueError(f"{name}: G must be a CUDA tensor (CPU tensors "
                         f"take the plain version through kernels.ops)")
    if G.dtype != torch.float32:
        raise TypeError(f"{name}: G must be float32, got {G.dtype}")
    if G.ndim != 2:
        raise ValueError(f"{name}: G must be [m, d], got {tuple(G.shape)}")
    if not G.is_contiguous():
        raise ValueError(f"{name}: G must be contiguous")
    m, d = G.shape
    if not 1 <= m <= MAX_M:
        raise ValueError(f"{name}: m={m} workers: the kernels take 1 <= m "
                         f"<= {MAX_M}")
    if d == 0:
        raise ValueError(f"{name}: G has no columns")
    return m, d


def _check_vector(v, G, n: int, name: str):
    if v.device != G.device or v.dtype != torch.float32 or \
            tuple(v.shape) != (n,) or not v.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 [{n}] "
                         f"tensor on {G.device}, got {v.dtype} "
                         f"{tuple(v.shape)} on {v.device}")


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _n_blocks(lib, d: int) -> int:
    threads = lib.brsgd_threads()
    return max(1, min(-(-d // threads), lib.brsgd_max_blocks()))


def _small_buffer(G, n_float: int, n_bytes: int, n_partials: int = 0):
    """One uint8 buffer for a launch's diagnostics: n_float floats, then
    n_bytes bytes, then (16-byte aligned) n_partials floats of scratch.
    Returns (buffer, byte offset of the scratch)."""
    off = -(-(4 * n_float + n_bytes) // 16) * 16
    return torch.empty(off + 4 * n_partials, dtype=torch.uint8,
                       device=G.device), off


def _launch(lib, name: str, fn, G, *args):
    with torch.cuda.device(G.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc} ({lib.brsgd_error_string(rc).decode()})")
    LAUNCHES[name] += 1


class ColumnPlan(NamedTuple):
    """The column pass's launch: ``grid`` blocks, each with a ring of
    ``stages`` tiles in ``smem`` bytes of dynamic shared memory."""
    grid: int
    stages: int
    smem: int


def column_stages(m: int, variant: int) -> int:
    """Ring stages of the column pass at m workers: enough that the
    stages in flight while one is read hold IN_FLIGHT_BYTES, within 2 ..
    MAX_STAGES (a stage is [m, RING_LD] floats: 10.6 KB at m = 20).  The
    trimmed mean takes TRIM_STAGES: it refills a stage as soon as its
    column is in registers, so that stage is in flight while the column
    sorts, and its heavier network (every slot kept) gains more from the
    blocks an SM a small ring leaves room for than from bytes in flight."""
    if variant == TRIM_OUT:
        return TRIM_STAGES
    stage = 4 * m * RING_LD
    return min(MAX_STAGES, max(2, 1 + -(-IN_FLIGHT_BYTES // stage)))


def column_smem(m: int, variant: int, stages: int) -> int:
    """Dynamic shared memory of a column-pass instance at m workers (csrc
    ``column_smem``): the sort columns where it takes a median and its
    instance has SMEM_SORT_M rows or more (the trimmed mean sorts in
    registers at every m), then the ring."""
    median = variant & (COLUMN_OUT | NEED_BITS["l1"] | NEED_BITS["d2med"])
    sort = ref.padded_workers(m) * THREADS \
        if median and instance_rows(m) >= SMEM_SORT_M else 0
    return 4 * (sort + stages * m * RING_LD)


def column_plan(m: int, d: int, variant: int, coresident) -> ColumnPlan:
    """Grid and ring of the column pass for G [m, d]: ``column_stages``
    stages and a persistent grid, the blocks the card holds at once
    (``coresident(smem)``), at most one a tile, and enough that no block
    takes 2^COUNT_PLANES tiles (its score counts' bits)."""
    stages = column_stages(m, variant)
    smem = column_smem(m, variant, stages)
    n = coresident(smem)
    if n < 1:
        raise RuntimeError(f"column pass: no block of m={m} fits on the "
                           f"card ({smem} bytes of shared memory)")
    n_tiles = -(-d // THREADS)
    least = -(-n_tiles // (2 ** COUNT_PLANES - 1))
    return ColumnPlan(min(n_tiles, max(n, least)), stages, smem)


# launch plans by (card, m, d, kind)
_plans: dict = {}


def column_launch_plan(G, variant: int) -> ColumnPlan:
    """:func:`column_plan` for G [m, d] on G's card, with the card's own
    co-resident block count of the instance; computed once per (card, m,
    d, variant)."""
    m, d = _check_matrix(G, "column pass")
    key = (G.device.index, m, d, "column", variant)
    if key not in _plans:
        lib = _lib(m)

        def coresident(smem):
            n = ctypes.c_int(0)
            rc = lib.brsgd_column_coresident(m, variant, smem,
                                             ctypes.byref(n))
            if rc != 0:
                raise RuntimeError(
                    f"column pass: occupancy query failed with CUDA error "
                    f"{rc} ({lib.brsgd_error_string(rc).decode()})")
            return n.value
        with torch.cuda.device(G.device):
            _plans[key] = column_plan(m, d, variant, coresident)
    return _plans[key]


# the most columns a block's score partial may count: below 2^24 a float
# holds every count, so the partials are exact and their double sum the
# exact score
MAX_BLOCK_COLUMNS = 1 << 24


def _total(name: str, parts, scores_dtype=torch.float32):
    """A statistic's total over the blocks' partials [grid, ...].  Score
    partials are whole counts: they are summed in double, exact past 2^24
    columns, and rounded once to ``scores_dtype`` (float: below 2^24 the
    float sum's bits; double: the exact count)."""
    if name == "scores":
        return parts.sum(dim=0, dtype=torch.float64).to(scores_dtype)
    return parts.sum(dim=0)


def fused_stats(G, needs, scores_dtype=torch.float32) -> dict:
    """G [m, d] -> {stat: tensor} for any subset of ``ref.STAT_NAMES``
    in one read of G: scores/l1/d2med [m], gram [m, m].  The scores come
    in ``scores_dtype`` (double keeps a count past 2^24 exact for a sum
    over views, as the sharded layouts take)."""
    m, d = _check_matrix(G, "fused_stats")
    needs = tuple(n for n in ref.STAT_NAMES if n in needs)
    if not needs:
        return {}
    lib = _lib(m)
    bits = sum(NEED_BITS[n] for n in needs)
    if "gram" in needs:
        nb, stages = _n_blocks(lib, d), 0
    else:
        plan = column_launch_plan(G, bits)
        nb, stages = plan.grid, plan.stages
    parts = {n: torch.empty((nb, m, m) if n == "gram" else (nb, m),
                            dtype=torch.float32, device=G.device)
             for n in needs}
    _launch(lib, "fused_stats", lib.brsgd_fused_stats, G, _ptr(G), m, d,
            bits, _ptr(parts.get("scores")), _ptr(parts.get("l1")),
            _ptr(parts.get("d2med")), _ptr(parts.get("gram")), nb, stages)
    return {n: _total(n, p, scores_dtype) for n, p in parts.items()}


def brsgd_partials(G):
    """G [m, d] -> (scores [m], l1 [m]): pass 1 of local BrSGD."""
    st = fused_stats(G, ("scores", "l1"))
    return st["scores"], st["l1"]


class AggregatePlan(NamedTuple):
    """The fused kernel's launch: ``grid`` co-resident blocks, whether G
    stays in shared memory between the passes, and the dynamic shared
    memory of each block in bytes."""
    grid: int
    resident: bool
    smem: int


def _check_rule(rule: str) -> None:
    if rule not in RULE_IDS:
        raise ValueError(f"no fused launch for rule {rule!r}; "
                         f"fused: {sorted(RULE_IDS)}")


def gram_pairs(m: int, rule: str) -> int:
    """The partial sums a fused launch of ``rule`` reduces over its grid
    (csrc AggLayout::PAIRS): brsgd's 2m (scores, l1); the packed upper
    triangle of gram, m(m+1)/2, and geomedian's m d2med sums."""
    _check_rule(rule)
    if rule == "brsgd":
        return 2 * m
    return m * (m + 1) // 2 + (m if rule == "geomedian" else 0)


def partials_floats(m: int, rule: str, grid: int) -> int:
    """Scratch of a fused launch on ``grid`` blocks: the per-block
    partials and their totals, and for the gram rules Σw after them."""
    return gram_pairs(m, rule) * (grid + 1) + (rule != "brsgd")


def aggregate_smem(m: int, d: int, grid: int, resident: bool,
                   rule: str = "brsgd") -> int:
    """Dynamic shared memory of the fused kernel of ``rule`` on ``grid``
    blocks (the csrc ``aggregate_smem``): the sort columns where the rule
    takes a median and m's instance has SMEM_SORT_M rows or more; the
    rule's scratch (krum: two
    [m, m+1] matrices; geomedian: one and 3m floats, to 16 bytes); then
    one tile slot per tile of the fullest block when resident, else the
    gram rules' one staging slot.  A brsgd slot is [m, THREADS]; a gram
    rule's is [m rounded up to GRAM_RB, GRAM_LD]."""
    _check_rule(rule)
    n_tiles = -(-d // THREADS)
    gram = rule != "brsgd"
    median = rule in ("brsgd", "geomedian")
    sort = ref.padded_workers(m) * THREADS \
        if median and instance_rows(m) >= SMEM_SORT_M else 0
    scratch = {"brsgd": 0, "krum": 2 * m * (m + 1),
               "multi_krum": 2 * m * (m + 1),
               "geomedian": -(-(m * (m + 1) + 3 * m) // 4) * 4}[rule]
    slot = (-(-m // GRAM_RB) * GRAM_RB * GRAM_LD) if gram else m * THREADS
    slots = -(-n_tiles // grid) if resident else (1 if gram else 0)
    return 4 * (sort + scratch + slots * slot)


def aggregate_plan(m: int, d: int, coresident,
                   rule: str = "brsgd") -> AggregatePlan:
    """Grid and residency of the fused kernel of ``rule`` for G [m, d].

    ``coresident(smem)`` is the number of blocks the card holds at once
    when each asks for ``smem`` bytes of dynamic shared memory.  The grid
    is min(tiles, co-resident blocks); G stays resident when some number
    of tiles per block fits in shared memory with the grid that number
    implies still co-resident — the fewest tiles per block that does."""
    limit = SMEM_BLOCK_LIMIT - AGG_STATIC_SMEM
    n_tiles = -(-d // THREADS)
    grid0 = min(n_tiles, coresident(aggregate_smem(m, d, 1, False, rule)))
    if grid0 < 1:
        raise RuntimeError(f"{rule} aggregate: no block of m={m} fits on "
                           f"the card")
    if -(-n_tiles // grid0) * THREADS >= MAX_BLOCK_COLUMNS:
        raise ValueError(f"{rule} aggregate: d={d} puts {MAX_BLOCK_COLUMNS} "
                         f"or more columns on a block of a {grid0}-block "
                         f"grid; its score counts would round")
    per_block = -(-n_tiles // grid0)
    while per_block <= n_tiles:
        grid = -(-n_tiles // per_block)
        smem = aggregate_smem(m, d, grid, True, rule)
        if smem > limit:
            break
        if grid <= coresident(smem):
            return AggregatePlan(grid, True, smem)
        per_block += 1
    return AggregatePlan(grid0, False,
                         aggregate_smem(m, d, grid0, False, rule))


def launch_plan(G, rule: str = "brsgd") -> AggregatePlan:
    """:func:`aggregate_plan` for G [m, d] on G's card, with the card's
    own co-resident block counts of ``rule``'s instance; computed once
    per (card, m, d, rule)."""
    _check_rule(rule)
    m, d = _check_matrix(G, f"{rule} aggregate")
    key = (G.device.index, m, d, rule)
    if key not in _plans:
        lib = _lib(m)

        def coresident(smem):
            n = ctypes.c_int(0)
            rc = lib.brsgd_select_aggregate_coresident(
                m, RULE_IDS[rule], smem, ctypes.byref(n))
            if rc != 0:
                raise RuntimeError(
                    f"{rule} aggregate: occupancy query failed with CUDA "
                    f"error {rc} ({lib.brsgd_error_string(rc).decode()})")
            return n.value
        with torch.cuda.device(G.device):
            _plans[key] = aggregate_plan(m, d, coresident, rule)
    return _plans[key]


def brsgd_aggregate(G, beta: float, threshold: float) -> ref.BrSGDAggregate:
    """Local BrSGD, G [m, d] -> aggregate [d] and its diagnostics, in one
    cooperative launch: pass 1, the thresholds resolved on the card, pass
    2.  Every output is a view of the two buffers the launch writes."""
    plan = launch_plan(G)                      # checks G
    m, d = G.shape
    lib = _lib(m)
    k_idx, q_idx = ref.brsgd_rank_indices(m, beta)
    n_float = 3 * m + 2                        # scores, l1, w, kth, 𝔗
    n_small = 4 * n_float + 3 * m              # then sel, c1, c2 as bytes
    buf, off = _small_buffer(G, n_float, 3 * m,  # then partials, totals
                             gram_pairs(m, "brsgd") * (plan.grid + 1))
    out = torch.empty((d,), dtype=torch.float32, device=G.device)
    _launch(lib, "brsgd_aggregate", lib.brsgd_select_aggregate, G, _ptr(G),
            m, d, RULE_IDS["brsgd"], k_idx, -1 if threshold > 0 else q_idx,
            threshold, int(plan.resident),
            ctypes.c_void_p(buf.data_ptr() + off), _ptr(buf), _ptr(out),
            plan.grid)
    f = buf[:4 * n_float].view(torch.float32)
    mk = buf[4 * n_float:n_small].view(torch.bool)
    return ref.BrSGDAggregate(out, f[2 * m:3 * m], mk[:m], mk[m:2 * m],
                              mk[2 * m:], f[:m], f[m:2 * m], f[3 * m],
                              f[3 * m + 1])


def select_aggregate(G, rule: str, n_close: int = 1, k: int = 0,
                     iters: int = 1, eps: float = 1e-6) -> ref.SelectAggregate:
    """A select rule over all of G [m, d] in one launch: the aggregate and
    its diagnostics (``ref.SelectAggregate``), every field a view of what
    the launch wrote.  krum / multi_krum / geomedian: the cooperative
    kernel (B1's gram pass, the rule on the card, B3's combine); the
    mean: B3 with unit weights, counted as ``masked_mean``.  Arguments as
    ``ref.select_aggregate_plain``."""
    if rule == "mean":
        m, d = _check_matrix(G, "masked_mean")
        buf, _ = _small_buffer(G, m, m)              # w, then w > 0
        out = torch.empty((d,), dtype=torch.float32, device=G.device)
        lib = _lib(m)
        _launch(lib, "masked_mean", lib.brsgd_masked_mean, G, _ptr(G), m, d,
                None, _ptr(out), _ptr(buf), _n_blocks(lib, d))
        return ref.SelectAggregate(out, buf[:4 * m].view(torch.float32),
                                   buf[4 * m:5 * m].view(torch.bool), None,
                                   None, None)
    if rule not in ("krum", "multi_krum", "geomedian"):
        raise ValueError(f"select_aggregate: unknown rule {rule!r}")
    plan = launch_plan(G, rule)                # checks G
    m, d = G.shape
    if rule == "geomedian":
        ia, ib, fa = max(int(iters) - 1, 0), 0, float(eps)
    else:
        if not 1 <= n_close <= m or (rule == "multi_krum"
                                     and not 1 <= k <= m):
            raise ValueError(f"{rule}: n_close={n_close}, k={k} outside "
                             f"[1, {m}]")
        ia, ib, fa = int(n_close), int(k) if rule == "multi_krum" else 0, 0.0
    n_float = 2 * m + m * m                    # w, scores or d2med, gram
    buf, off = _small_buffer(G, n_float, m,    # then w > 0 as bytes
                             partials_floats(m, rule, plan.grid))
    out = torch.empty((d,), dtype=torch.float32, device=G.device)
    lib = _lib(m)
    _launch(lib, "select_aggregate", lib.brsgd_select_aggregate, G, _ptr(G),
            m, d, RULE_IDS[rule], ia, ib, fa, int(plan.resident),
            ctypes.c_void_p(buf.data_ptr() + off), _ptr(buf), _ptr(out),
            plan.grid)
    f = buf[:4 * n_float].view(torch.float32)
    sel = buf[4 * n_float:4 * n_float + m].view(torch.bool)
    second = f[m:2 * m]
    return ref.SelectAggregate(
        out, f[:m], sel, None if rule == "geomedian" else second,
        f[2 * m:].view(m, m), second if rule == "geomedian" else None)


def select_mean(G, scores, l1, kth, T):
    """Pass 2 of local BrSGD: C1∩C2 selection fused with the masked
    mean, from the thresholds (kth, 𝔗) that ``ref.brsgd_thresholds``
    resolved.  Returns (aggregate [d], selection weights [m])."""
    m, d = _check_matrix(G, "select_mean")
    _check_vector(scores, G, m, "select_mean scores")
    _check_vector(l1, G, m, "select_mean l1")
    sl = torch.stack([scores, l1]).contiguous()                  # [2, m]
    pr = torch.stack([kth, 2.0 * T]).to(torch.float32)           # [2]
    _check_vector(pr, G, 2, "select_mean thresholds")
    out = torch.empty((d,), dtype=torch.float32, device=G.device)
    w = torch.empty((m,), dtype=torch.float32, device=G.device)
    lib = _lib(m)
    _launch(lib, "select_mean", lib.brsgd_select_mean, G, _ptr(G), m, d,
            _ptr(sl), _ptr(pr), _ptr(out), _ptr(w), _n_blocks(lib, d))
    return out, w


def masked_mean(G, mask):
    """Σ w_i g_i / Σ w_i over the rows, Σw in row order; mask [m] bool or
    f32 weights, an empty mask divides by 1."""
    m, d = _check_matrix(G, "masked_mean")
    w = mask.to(device=G.device, dtype=torch.float32).contiguous()
    _check_vector(w, G, m, "masked_mean mask")
    out = torch.empty((d,), dtype=torch.float32, device=G.device)
    lib = _lib(m)
    _launch(lib, "masked_mean", lib.brsgd_masked_mean, G, _ptr(G), m, d,
            _ptr(w), _ptr(out), None, _n_blocks(lib, d))
    return out


def brsgd_stats(G):
    """G [m, d] -> (median [d], mean [d], scores [m], l1 [m])."""
    plan = column_launch_plan(G, B4_VARIANT)       # checks G
    m, d = G.shape
    lib = _lib(m)
    med = torch.empty((d,), dtype=torch.float32, device=G.device)
    mean = torch.empty((d,), dtype=torch.float32, device=G.device)
    sc = torch.empty((plan.grid, m), dtype=torch.float32, device=G.device)
    l1 = torch.empty((plan.grid, m), dtype=torch.float32, device=G.device)
    _launch(lib, "brsgd_stats", lib.brsgd_column_stats, G, _ptr(G), m, d,
            _ptr(med), _ptr(mean), _ptr(sc), _ptr(l1), plan.grid,
            plan.stages)
    return med, mean, _total("scores", sc), l1.sum(dim=0)


def cwise_median(G):
    """Coordinate-wise median [d] (the median output of brsgd_stats) in
    one launch that writes nothing else."""
    plan = column_launch_plan(G, COLUMN_OUT)       # checks G
    m, d = G.shape
    lib = _lib(m)
    med = torch.empty((d,), dtype=torch.float32, device=G.device)
    _launch(lib, "cwise_median", lib.brsgd_cwise_median, G, _ptr(G), m, d,
            _ptr(med), plan.grid, plan.stages)
    return med


def trimmed_mean(G, trim_frac: float):
    """Coordinate-wise trimmed mean [d]: per column, the mean of the
    sorted rows k..m-k-1 with k = ``ref.trim_k(trim_frac, m)``, in one
    column-pass launch that writes nothing else."""
    plan = column_launch_plan(G, TRIM_OUT)         # checks G
    m, d = G.shape
    lib = _lib(m)
    out = torch.empty((d,), dtype=torch.float32, device=G.device)
    _launch(lib, "trimmed_mean", lib.brsgd_trimmed_mean, G, _ptr(G), m, d,
            ref.trim_k(trim_frac, m), _ptr(out), plan.grid, plan.stages)
    return out
