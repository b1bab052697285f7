"""The port's continuous-batching serve loop (``repro_torch.serving``)
against the JAX package's (``repro.serving``) and against its own solo
decodes, for qwen3-0.6b-smoke and rwkv6-7b-smoke (2 layers, d = 256,
vocab 512, float32 cache), on the CPU.

Tolerances.  Within the port on one device tokens are exact (a loop
against its own batch-1 decode, as the JAX tests pin it).  Between the
two frameworks a greedy token may differ at a near tie: a first
difference is allowed only where the reference's top-two logits lie
within 1e-4 of its max|logit| (the rest of that request is then not
compared), and the first token's logits agree within 1e-5 of max|logit|.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as j_get_config
from repro.launch import serve as jserve
from repro.models import params as JPM
from repro.models import transformer as JTF
from repro.serving import ServeLoop as JServeLoop
from repro.serving import batch_axes as j_batch_axes
from repro.serving.telemetry import ServeMetrics as JServeMetrics
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.faults import get_spec
from repro_torch.launch import serve
from repro_torch.models import params as TPM
from repro_torch.models import transformer as TTF
from repro_torch.serving import (BlockTable, HotSwapper, ServeLoop,
                                 ServeMetrics, SlotCache, append_row,
                                 batch_axes, latest_row, read_rows)
from repro_torch.serving.scheduler import _next_pow2
from repro_torch.serving.telemetry import TRAIN_KEYS

ARCHS = ("qwen3-0.6b", "rwkv6-7b")
NEAR_TIE = 1e-4
FIRST_LOGITS_TOL = 1e-5
# a stream with joins, finishes and slot reuse at max_batch 4
PROMPTS = (3, 5, 7, 4, 6, 5)
GENS = (6, 4, 8, 3, 5, 7)
MAX_LEN = 24


def _params(arch, seed=0):
    """JAX params of the reduced config, perturbed by seeded noise (so
    the zero- and one-initialised leaves take part), and the port's
    copy."""
    jcfg = j_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jp = JPM.init_params(JTF.param_defs(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32)),
        jp)
    return jcfg, tcfg, jp, TPM.params_from_jax(jp)


def _stream(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=p) for p in PROMPTS]


def _bucket(cfg, S, max_len):
    if cfg.rwkv is not None or cfg.attention.window:
        return S
    return min(_next_pow2(S), max_len - 1)


def _jax_logits(jcfg, jp, prompt, tokens, j, max_len):
    """The JAX reference's logits that decide token j of a request
    (batch 1, the loop's padded prefill, then teacher-forced decode)."""
    S = len(prompt)
    Sb = _bucket(jcfg, S, max_len)
    toks = np.zeros((1, Sb), np.int32)
    toks[0, :S] = prompt
    lg, cache = JTF.prefill_cache(jcfg, jp, jnp.asarray(toks),
                                  JTF.init_cache(jcfg, 1, max_len,
                                                 jnp.float32))
    out = np.asarray(lg[0, S - 1])
    for i in range(j):
        lg, cache = JTF.decode_step(jcfg, jp, cache,
                                    jnp.asarray([[tokens[i]]], jnp.int32),
                                    jnp.int32(S + i))
        out = np.asarray(lg[0, 0])
    return out


def _first_difference_is_a_near_tie(got, want, logits_at) -> bool:
    """False when the streams are equal; True when they first differ at
    a near tie of the reference; else fail."""
    assert len(got) == len(want)
    diff = np.flatnonzero(np.asarray(got) != np.asarray(want))
    if not diff.size:
        return False
    j = int(diff[0])
    lg = logits_at(j)
    top = np.sort(lg)[-2:]
    margin = float(top[1] - top[0])
    assert margin <= NEAR_TIE * float(np.abs(lg).max()), (
        f"token {j} differs: {got[j]} vs {want[j]}, reference margin "
        f"{margin} of max|logit| {np.abs(lg).max()}")
    return True


# ---------------------------------------------------------------------------
# the slot map and the slot cache
# ---------------------------------------------------------------------------

def test_block_table():
    t = BlockTable(2)
    s0, s1 = t.alloc(10), t.alloc(11)
    assert {s0, s1} == {0, 1} and not t.free_slots and len(t) == 2
    assert t.slot(11) == s1
    t.free(10)
    assert t.alloc(12) == s0                # slot reuse
    with pytest.raises(RuntimeError, match="no free slots"):
        t.alloc(13)


def _leaves(tree):
    return [x for k in sorted(tree) for x in
            (_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_cache_insert_in_place(arch):
    """insert copies a batch-1 slice into its slot of every leaf on the
    batch axis that batch_axes reads from TF.cache_defs (the JAX
    package's axes), in place; the other slots stay as they were."""
    cfg = get_config(arch).reduced()
    assert batch_axes(cfg, 4, 16) == j_batch_axes(
        j_get_config(arch).reduced(), 4, 16)
    sc = SlotCache(cfg, 4, 16, torch.float32)
    gen = torch.Generator().manual_seed(0)
    for b in _leaves(sc.bufs):
        b.copy_(torch.randn(b.shape, generator=gen))
    before = [b.clone() for b in _leaves(sc.bufs)]
    ptrs = [b.data_ptr() for b in _leaves(sc.bufs)]
    small = TTF.init_cache(cfg, 1, 16, torch.float32)
    for s in _leaves(small):
        s.copy_(torch.randn(s.shape, generator=gen))
    sc.insert(small, 2)
    assert ptrs == [b.data_ptr() for b in _leaves(sc.bufs)]
    for b, old, s, ax in zip(_leaves(sc.bufs), before, _leaves(small),
                             _leaves(sc.axes)):
        assert torch.equal(b.narrow(ax, 2, 1), s)
        for other in (0, 1, 3):
            assert torch.equal(b.narrow(ax, other, 1),
                               old.narrow(ax, other, 1))


def test_rwkv_decode_writes_the_cache_in_place():
    """decode_step writes every rwkv entry into the cache stacks in
    place (a CUDA graph holds their addresses); the token-shift carries
    are float32 buffers whatever the cache dtype."""
    cfg = get_config("rwkv6-7b").reduced()
    params = TPM.init_params(TTF.param_defs(cfg),
                             torch.Generator().manual_seed(0))
    cache = TTF.init_cache(cfg, 2, 8, torch.bfloat16)
    leaves = {id(t): t.data_ptr() for t in _leaves(cache)}
    assert cache["seg_0"]["wkv"].dtype == torch.bfloat16
    assert cache["seg_0"]["tm_x"].dtype == torch.float32
    tokens = torch.tensor([[3, 4, 5], [6, 7, 8]])
    _, cache2 = TTF.prefill_cache(cfg, params, tokens, cache)
    lg, cache3 = TTF.decode_step(cfg, params, cache2, tokens[:, :1],
                                 torch.tensor([3, 3]))
    assert cache3 is cache
    assert {id(t): t.data_ptr() for t in _leaves(cache3)} == leaves
    assert torch.isfinite(lg).all()
    assert cache["seg_0"]["wkv"].abs().sum() > 0


# ---------------------------------------------------------------------------
# the loop: continuity, against JAX, bucketing, stalls
# ---------------------------------------------------------------------------

def _run(loop, prompts, gens=GENS):
    rids = [loop.submit(p, g) for p, g in zip(prompts, gens)]
    done = loop.run()
    assert set(done) == set(rids)
    return [done[r] for r in rids]


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_continuity(arch):
    """Requests served through the shared [max_batch] slot array emit
    exactly the tokens a solo batch-1 loop emits: dead slots and slot
    reuse never leak into live requests."""
    _, cfg, _, tp = _params(arch)
    prompts = _stream(cfg)
    loop = ServeLoop(cfg, max_batch=4, max_len=MAX_LEN, params=tp)
    got = _run(loop, prompts)
    assert loop.decode_graphs() == 0            # the CPU runs eagerly
    assert loop.decode_launches == {} and loop.prefill_launches == {}
    for toks, prompt, g in zip(got, prompts, GENS):
        solo = ServeLoop(cfg, max_batch=1, max_len=MAX_LEN, params=tp)
        np.testing.assert_array_equal(toks, _run(solo, [prompt], [g])[0])
        assert len(toks) == g


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_loop_matches_jax(arch):
    """The port's loop and the JAX package's on the same stream and
    params: tokens equal under the near-tie rule; the first token's
    logits (the loop's padded prefill at S - 1) within 1e-5."""
    jcfg, tcfg, jp, tp = _params(arch, seed=4)
    prompts = _stream(tcfg, seed=5)
    want = _run(JServeLoop(jcfg, max_batch=4, max_len=MAX_LEN, params=jp),
                prompts)
    got = _run(ServeLoop(tcfg, max_batch=4, max_len=MAX_LEN, params=tp),
               prompts)
    for prompt, g, w in zip(prompts, got, want):
        _first_difference_is_a_near_tie(
            g, w, lambda j: _jax_logits(jcfg, jp, prompt, w, j, MAX_LEN))
        S = len(prompt)
        Sb = _bucket(tcfg, S, MAX_LEN)
        toks = np.zeros((1, Sb), np.int64)
        toks[0, :S] = prompt
        tl, _ = TTF.prefill_cache(tcfg, tp, torch.from_numpy(toks),
                                  TTF.init_cache(tcfg, 1, MAX_LEN,
                                                 torch.float32))
        jl = _jax_logits(jcfg, jp, prompt, w, 0, MAX_LEN)
        np.testing.assert_allclose(tl[0, S - 1].numpy(), jl, rtol=0,
                                   atol=FIRST_LOGITS_TOL * np.abs(jl).max())


def test_prefill_bucketing_policy():
    """Attention-only configs pad prompts to power-of-two buckets (one
    shape for 5..8); recurrent configs prefill at exact length."""
    _, cfg, _, tp = _params("qwen3-0.6b")
    rng = np.random.default_rng(0)
    loop = ServeLoop(cfg, max_batch=2, max_len=32, params=tp)
    _run(loop, [rng.integers(0, cfg.vocab, size=p) for p in (5, 6, 7, 8)],
         [2] * 4)
    assert loop.prefill_shapes() == 1
    _, cfg_r, _, tp_r = _params("rwkv6-7b")
    loop_r = ServeLoop(cfg_r, max_batch=2, max_len=32, params=tp_r)
    _run(loop_r, [rng.integers(0, cfg_r.vocab, size=p) for p in (5, 6)],
         [2, 2])
    assert loop_r.prefill_shapes() == 2
    assert _bucket(cfg, 17, 32) == 31 and _bucket(cfg, 3, 32) == 4


def test_stalled_slot_times_out_and_requeues():
    """A wedged slot (fault ``slot_stall``) stops its request; the
    watchdog requeues it and it completes from scratch with the tokens
    an unstalled loop emits."""
    _, cfg, _, tp = _params("qwen3-0.6b")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=p) for p in (3, 5, 4)]
    loop = ServeLoop(cfg, max_batch=2, max_len=MAX_LEN, params=tp,
                     request_timeout=4)
    fired = {}

    def on_step(lp, s):
        if s == 2 and not fired:
            ctx = type("Ctx", (), {"loop": lp, "stall_ticks": 12})()
            fired["detail"] = get_spec("slot_stall").inject(
                ctx, np.random.default_rng(0))

    rids = [loop.submit(p, 6) for p in prompts]
    done = loop.run(on_step=on_step)
    assert set(done) == set(rids) and all(len(done[r]) == 6 for r in rids)
    assert loop.metrics.requeues >= 1 and loop.metrics.completed == 3
    assert "stalled slot" in fired["detail"]
    clean = _run(ServeLoop(cfg, max_batch=2, max_len=MAX_LEN, params=tp),
                 prompts, [6] * 3)
    for r, want in zip(rids, clean):
        np.testing.assert_array_equal(done[r], want)


def test_serve_loop_wedge_is_loud():
    _, cfg, _, tp = _params("qwen3-0.6b")
    loop = ServeLoop(cfg, max_batch=1, max_len=16, params=tp)
    loop.submit(np.arange(3), 4)

    def on_step(lp, s):
        if s == 1:
            lp.inject_stall(0, 10**9)       # wedged forever, no timeout

    with pytest.raises(RuntimeError, match="wedged"):
        loop.run(on_step=on_step)
    with pytest.raises(ValueError, match="exactly one"):
        ServeLoop(cfg, 1, 16)
    with pytest.raises(ValueError, match="max_len"):
        loop.submit(np.arange(16), 2)


# ---------------------------------------------------------------------------
# hot swap and quarantine
# ---------------------------------------------------------------------------

def _reference(cfg, params_old, params_new, prompt, gen, swap_step):
    """Greedy batch-1 decode switching params after ``swap_step`` decode
    steps (None = never), sharing the cache across the switch."""
    cache = TTF.init_cache(cfg, 1, MAX_LEN, torch.float32)
    logits, cache = TTF.prefill_cache(cfg, params_old,
                                      torch.from_numpy(prompt[None]), cache)
    tok = int(torch.argmax(logits[0, -1]))
    toks, pos = [tok], len(prompt)
    for i in range(gen - 1):
        p = params_old if swap_step is None or i < swap_step else params_new
        logits, cache = TTF.decode_step(cfg, p, cache, torch.tensor([[tok]]),
                                        pos)
        tok = int(torch.argmax(logits[0, 0]))
        toks.append(tok)
        pos += 1
    return np.asarray(toks, np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_hot_swap_under_decode(arch, tmp_path):
    """A checkpoint published after decode step 4 lands at step 5: every
    post-swap token matches a reference that switches params there, and
    the stream differs from the never-swapped one."""
    _, cfg, _, params_old = _params(arch)
    params_new = _neg(params_old)
    d = str(tmp_path)
    ckpt.save(d, params_old, step=1)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, size=6)
    gen, swap_at = 10, 4
    swapper = HotSwapper(d, like=params_old, device="cpu")
    loop = ServeLoop(cfg, max_batch=1, max_len=MAX_LEN, swapper=swapper)
    rid = loop.submit(prompt, gen)

    def on_step(lp, s):
        if s == swap_at:
            ckpt.save(d, params_new, step=2)

    got = loop.run(on_step=on_step)[rid]
    assert swapper.swap_count == 1 and swapper.loaded_step == 2
    assert loop.metrics.swaps == 1 and loop.decode_graphs() == 0
    np.testing.assert_array_equal(
        got, _reference(cfg, params_old, params_new, prompt, gen, swap_at))
    assert not np.array_equal(
        got, _reference(cfg, params_old, params_new, prompt, gen, None))


def _neg(tree):
    if isinstance(tree, dict):
        return {k: _neg(v) for k, v in tree.items()}
    return -tree


def _small_tree(x):
    return {"w": torch.full((4, 3), float(x)), "b": torch.arange(3.0)}


@pytest.mark.parametrize("fault", ["torn_ckpt", "corrupt_ckpt"])
def test_hot_swapper_quarantines_bad_publish(fault, tmp_path):
    d = str(tmp_path)
    ckpt.save(d, _small_tree(1), step=1)
    sw = HotSwapper(d, like=_small_tree(0), device="cpu")
    assert sw.loaded_step == 1
    slots = [id(s) for s in sw._slots]
    ckpt.save(d, _small_tree(2), step=2)
    get_spec(fault).inject(d, 2, np.random.default_rng(0))
    assert not sw.poll()                    # bad publish: kept serving 1
    assert sw.loaded_step == 1 and 2 in sw.quarantined
    assert torch.equal(sw.params()["w"], _small_tree(1)["w"])
    ckpt.save(d, _small_tree(3), step=3)
    assert sw.poll() and sw.loaded_step == 3
    assert not sw.poll()                    # quarantined step never retried
    assert torch.equal(sw.params()["w"], _small_tree(3)["w"])
    assert [id(s) for s in sw._slots] == slots  # allocated once
    assert sw.swap_count == 1 and sw.staleness_s() >= 0
    with pytest.raises(FileNotFoundError):
        HotSwapper(str(tmp_path / "none"), like=_small_tree(0), device="cpu")


def test_loop_keeps_serving_through_bad_publishes(tmp_path):
    """A torn and a corrupt publish under live decode are quarantined;
    every request completes with the never-swapped tokens."""
    _, cfg, _, tp = _params("qwen3-0.6b")
    d = str(tmp_path)
    ckpt.save(d, tp, step=1)
    swapper = HotSwapper(d, like=tp, device="cpu")
    loop = ServeLoop(cfg, max_batch=2, max_len=MAX_LEN, swapper=swapper)
    prompts = _stream(cfg, seed=3)[:3]

    def on_step(lp, s):
        if s in (2, 4):
            step = s // 2 + 1
            ckpt.save(d, _neg(tp), step=step)
            get_spec("torn_ckpt" if s == 2 else "corrupt_ckpt").inject(
                d, step, np.random.default_rng(s))

    rids = [loop.submit(p, 5) for p in prompts]
    done = loop.run(on_step=on_step)
    got = [done[r] for r in rids]
    assert sorted(swapper.quarantined) == [2, 3]
    assert swapper.loaded_step == 1 and swapper.swap_count == 0
    assert "quarantined_ckpts 2" in loop.metrics.render()
    want = _run(ServeLoop(cfg, max_batch=2, max_len=MAX_LEN, params=tp),
                prompts, [5] * 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# telemetry and the entry point
# ---------------------------------------------------------------------------

def test_metrics_render_equals_jax(monkeypatch):
    clock = {"t": 100.0}
    monkeypatch.setattr(time, "perf_counter", lambda: clock["t"])
    ms = [ServeMetrics(), JServeMetrics()]
    row = {"step": 4, "gnorm": 1.25, "n_selected": 6.0,
           "n_selected_min": 5.0, "n_active": 8.0, "quorum": 6}
    for m in ms:
        for dt in (0.002, 0.004, 0.001, 0.0125):
            m.observe_decode(dt, n_live=3)
        m.observe_swap(0.05)
        m.prefills, m.requeues, m.completed = 4, 1, 3
        m.queue_depth, m.active_slots = 2, 1
        m.gauge("ckpt_staleness_s", 1.5)
        m.gauge("quarantined_ckpts", 2)
    clock["t"] = 102.5
    assert ms[0].render(row) == ms[1].render(row)
    assert ms[0].render() == ms[1].render()
    assert ms[0].snapshot(row) == ms[1].snapshot(row)


def test_telemetry_roundtrip(tmp_path, monkeypatch):
    d = str(tmp_path)
    synced = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (synced.append(fd),
                                                 real_fsync(fd))[1])
    rows = [{"step": i, "gnorm": 1.0 + i, "n_selected": 6.0,
             "n_selected_min": 5.0, "n_active": 8.0, "quorum": 6}
            for i in range(3)]
    for r in rows:
        append_row(d, r)
    assert len(synced) == 3
    with open(os.path.join(d, "telemetry.jsonl"), "a") as f:
        f.write('{"step": 3, "gnorm"')        # torn tail line
    assert [r["step"] for r in read_rows(d)] == [0, 1, 2]
    assert latest_row(d)["step"] == 2
    assert latest_row(str(tmp_path / "none")) is None
    with pytest.raises(ValueError, match="missing keys"):
        append_row(d, {"step": 9})
    text = ServeMetrics().render(rows[-1])
    for k in TRAIN_KEYS:
        assert f"repro_train_{k}" in text


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_serve_loop_matches_jax_launcher(arch, tmp_path):
    """serve.main --serve-loop on the CPU, from a port checkpoint, drops
    no request, writes the metrics, and emits the JAX launcher's tokens on
    the same checkpoint and seed (its prompt draws are the JAX
    launcher's), under the near-tie rule."""
    jcfg, tcfg, jp, tp = _params(arch, seed=6)
    d = str(tmp_path / "ck")
    ckpt.save(d, tp, step=1)
    append_row(d, {"step": 1, "gnorm": 1.0, "n_selected": 6.0,
                   "n_selected_min": 5.0, "n_active": 8.0, "quorum": 6})
    args = ["--arch", arch, "--reduced", "--serve-loop", "--requests", "5",
            "--max-batch", "2", "--prompt-len", "8", "--gen", "4",
            "--seed", "3", "--ckpt-dir", d]
    out = str(tmp_path / "metrics.txt")
    res = serve.main(args + ["--device", "cpu", "--metrics-out", out])
    assert len(res["done"]) == 5 and res["decode_graphs"] == 0
    assert res["loop"].swapper.loaded_step == 1
    with open(out) as f:
        text = f.read()
    assert "repro_serve_requests_completed 5" in text
    assert "repro_train_gnorm 1" in text
    want = jserve.main(args)
    rng = np.random.RandomState(3)
    for rid in range(5):
        plen = rng.randint(4, 9)
        prompt = rng.randint(0, tcfg.vocab, size=plen)
        _first_difference_is_a_near_tie(
            res["done"][rid], want[rid],
            lambda j: _jax_logits(jcfg, jp, prompt, want[rid], j, 12))
    jckpt.restore(d, like=jp)                # the same file in both


def test_serve_main_serve_loop_from_seed():
    res = serve.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                      "--serve-loop", "--requests", "3", "--max-batch", "2",
                      "--prompt-len", "6", "--gen", "3"])
    assert sorted(res["done"]) == [0, 1, 2]
    assert all(len(v) == 3 for v in res["done"].values())
    assert res["prefills"] == 3 and res["launches"] == {}
    assert res["decode_tokens"] == 6          # the first token is prefill's


def test_serve_loop_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "qwen3-0.6b", "--reduced", "--serve-loop"])
