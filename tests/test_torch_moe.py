"""The port's MoE segment (``models/moe.py`` and the moe blocks of
``models/transformer.py``) and its two configs, dbrx-132b and
deepseek-v2-236b, against the JAX package on the same numpy inputs:

* ``route``, ``dispatch_indices`` and ``moe_ffn`` at a lossless and a
  tight capacity (drops present): the expert ids, the slot tables, the
  validity, ``slot_of`` exact; the weights, the output and aux within
  1e-5 of their largest magnitude; against ``ref_dense_moe`` when
  lossless.  A tie in the router's probabilities goes to the lower
  expert index (``lax.top_k``'s order), with shared experts.  The
  capacity is the call's: a token's output depends on the batch it is
  routed in unless dispatch is lossless.
* The fan-in of an expert leaf counts the experts axis (it is not a
  stack axis): ``w_in``'s std is 1/sqrt(E·d).
* The configs field by field, full and reduced; at 2 reduced layers
  (dbrx: 2 moe layers; deepseek-v2: its dense layer and one moe layer)
  the forward logits, the loss with its aux and every gradient leaf
  (``jax.value_and_grad``), the fused prefill and 4 teacher-forced
  decode steps over a float32 and a bfloat16 cache, at
  ``test_torch_zoo.py``'s tolerances.
* MLA at deepseek-v2's head widths (q/k 128 + 64, v 128) with a narrow
  model width, and B6's plain version and its gradient at (192, 128)
  against float64.

Tolerances: logits within 1e-4 of the largest |logit|, cache leaves
within 1e-4 of their largest magnitude (float32 cache; the prefill
logits also over the bfloat16 one); over a bfloat16 cache the decode
logits within 2^-8 (one bfloat16 step) and the cache leaves within
2^-7; the loss within 1e-5
relative and each gradient leaf within 1e-4 of its largest |g|; the
plain attention within 1e-5 of float64.

The decode logits over a bfloat16 cache take a wider limit than the
dense archs' 1e-3 (``test_torch_zoo.py``): a value rounded to bfloat16
from float32 inputs that differ in their last bits can land one
bfloat16 step apart (ROADMAP §C.4), and the next moe layer's router
carries that step into its top-k weights.  The JAX package's own decode
moves that far: at dbrx-132b-smoke, weights moved by one ulp change its
decode logits over the bfloat16 cache by up to 2.3e-3 of the largest
|logit| (1e-6 over the float32 cache).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import base as jbase
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models import params as JPM
from repro.models import transformer as JTF
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa_kern
from repro_torch.kernels import ref
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import params as TPM
from repro_torch.models import transformer as TTF

ARCHS = ("dbrx-132b", "deepseek-v2-236b")
TOL = 1e-4
MOE_TOL = 1e-5
MOE_BF16_DECODE_TOL = 2.0 ** -8
MLA_BF16_TOL = 1e-3           # one MLA decode layer over a bfloat16 cache
BF16_CACHE_TOL = 2.0 ** -7
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def close(got, want, rtol=TOL):
    got = np.asarray(torch.as_tensor(got).detach().float() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(torch.as_tensor(got)),
                                  np.asarray(want))


# the JAX functions jitted once (the spec and the capacity static)
j_route = jax.jit(JMOE.route, static_argnums=2)
j_dispatch = jax.jit(JMOE.dispatch_indices, static_argnums=(2, 3))
j_moe_ffn = jax.jit(JMOE.moe_ffn, static_argnums=(2, 3, 4))
j_dense = jax.jit(JMOE.ref_dense_moe, static_argnums=(2, 3))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}/{k}"))
        return out
    return {path: tree}


# ---------------------------------------------------------------------------
# moe.py
# ---------------------------------------------------------------------------

def _moe(E=4, k=2, d=32, f=48, T=40, cap=100.0, shared=0, seed=0):
    """A JAX MoE layer perturbed by seeded noise, its port, and x [T, d]."""
    spec = dict(n_experts=E, top_k=k, d_ff_expert=f, capacity_factor=cap,
                n_shared=shared)
    js, ts = jbase.MoESpec(**spec), tbase.MoESpec(**spec)
    jp = JPM.init_params(JMOE.moe_defs(d, js), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp = {k_: jnp.asarray(np.asarray(a) + 0.02 * rng.normal(size=a.shape)
                          .astype(np.float32)) for k_, a in jp.items()}
    x = rng.normal(size=(T, d)).astype(np.float32)
    return js, ts, jp, TPM.params_from_jax(jp), x


@pytest.mark.parametrize("cap", [100.0, 0.5])
@pytest.mark.parametrize("shared", [0, 2])
def test_route_dispatch_and_moe_ffn_match_jax(cap, shared):
    """cap 100: lossless (also against both dense oracles); cap 0.5: the
    capacity is max(4, ceil(40·2·0.5/4)) = 10 slots an expert for 80
    assignments, so assignments are dropped."""
    js, ts, jp, tp, x = _moe(cap=cap, shared=shared)
    jw, jids, jaux = j_route(jp["router"], jnp.asarray(x), js)
    tw, tids, taux = TMOE.route(tp["router"], torch.from_numpy(x), ts)
    exact(tids, jids)
    close(tw, jw, MOE_TOL)
    assert abs(float(taux) - float(jaux)) <= MOE_TOL * abs(float(jaux))
    C = TMOE.capacity(x.shape[0], ts)
    assert C == JMOE.capacity(x.shape[0], js)
    # the tables from the same ids and weights: exact
    jt = j_dispatch(jids, jw, js, C)
    tt = TMOE.dispatch_indices(torch.from_numpy(np.asarray(jids)),
                               torch.from_numpy(np.asarray(jw)), ts, C)
    for got, want in zip(tt, jt):
        exact(got, want)
    dropped = int((np.asarray(jt[3]) == js.n_experts * C).sum())
    assert (dropped > 0) == (cap < 1)
    jout, jaux2 = j_moe_ffn(jp, jnp.asarray(x), js)
    tout, taux2 = TMOE.moe_ffn(tp, torch.from_numpy(x), ts)
    close(tout, jout, MOE_TOL)
    assert abs(float(taux2) - float(jaux2)) <= MOE_TOL * abs(float(jaux2))
    if cap > 1:
        close(tout, j_dense(jp, jnp.asarray(x), js), MOE_TOL)
        close(TMOE.ref_dense_moe(tp, torch.from_numpy(x), ts), jout,
              MOE_TOL)


def test_a_tie_goes_to_the_lower_expert_index():
    """Router columns 0 = 2 and 1 = 3: every token's probabilities tie in
    pairs, so its top 3 are (0, 2, 1) or (1, 3, 0), the lower index of
    each tie first, as lax.top_k orders them; with 2 shared experts."""
    js, ts, jp, _, x = _moe(k=3, shared=2, seed=3)
    r = np.asarray(jp["router"]).copy()
    r[:, 2], r[:, 3] = r[:, 0], r[:, 1]
    jp = {**jp, "router": jnp.asarray(r)}
    tp = TPM.params_from_jax(jp)
    jw, jids, _ = j_route(jp["router"], jnp.asarray(x), js)
    tw, tids, _ = TMOE.route(tp["router"], torch.from_numpy(x), ts)
    ids = tids.numpy()
    assert {tuple(row) for row in ids} <= {(0, 2, 1), (1, 3, 0)}
    assert len({tuple(row) for row in ids}) == 2
    exact(tids, jids)
    close(tw, jw, MOE_TOL)
    close(TMOE.moe_ffn(tp, torch.from_numpy(x), ts)[0],
          j_moe_ffn(jp, jnp.asarray(x), js)[0], MOE_TOL)


def test_capacity_is_the_calls_own():
    """A token's output alone equals its output in the batch only where
    dispatch is lossless: at a tight capacity the batch's earlier tokens
    take the slots (both packages alike)."""
    for cap, lossless in ((2.0, True), (0.5, False)):
        js, ts, jp, tp, x = _moe(E=4, k=2, T=24, cap=cap, seed=5)
        assert (ts.capacity_factor >= ts.n_experts / ts.top_k) == lossless
        batch = TMOE.moe_ffn(tp, torch.from_numpy(x), ts)[0]
        alone = torch.cat([TMOE.moe_ffn(tp, torch.from_numpy(x[i:i + 1]),
                                        ts)[0] for i in range(len(x))])
        close(batch, j_moe_ffn(jp, jnp.asarray(x), js)[0], MOE_TOL)
        diff = float((batch - alone).abs().max() / alone.abs().max())
        assert (diff <= MOE_TOL) == lossless, diff


def test_expert_fan_in_counts_the_experts_axis():
    E, d, f = 8, 48, 16
    leaf = TPM.ParamDef((2, E, d, f), ("layers", "experts", "embed", "ff"))
    assert TPM._fan_in(leaf) == E * d
    js = jbase.MoESpec(n_experts=E, top_k=2, d_ff_expert=f)
    jp = JPM.init_params(JTF._stack(JMOE.moe_defs(d, js), 2),
                         jax.random.PRNGKey(0))
    tdefs = TTF._stack(TMOE.moe_defs(d, tbase.MoESpec(
        n_experts=E, top_k=2, d_ff_expert=f)), 2)
    tp = TPM.init_params(tdefs, torch.Generator().manual_seed(0))
    for name, fan in (("w_in", E * d), ("w_gate", E * d),
                      ("w_out", E * f), ("router", d)):
        for std in (float(np.asarray(jp[name]).std()),
                    float(tp[name].std())):
            assert abs(std * np.sqrt(fan) - 1.0) < 0.05, (name, std)


# ---------------------------------------------------------------------------
# the configs and the model at 2 reduced layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_jax_config_field_by_field(arch):
    for reduce in (False, True):
        jc, tc = j_get_config(arch), get_config(arch)
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        for f in dataclasses.fields(jc):
            assert dataclasses.asdict(tc)[f.name] == \
                dataclasses.asdict(jc)[f.name], (arch, reduce, f.name)
        assert tc.is_moe and jc.is_moe
        assert ([tuple(s) for s in TTF.segments(tc)]
                == [tuple(s) for s in JTF.segments(jc)])
    assert TPM.count_params(TTF.param_defs(get_config(arch))) == \
        JPM.count_params(JTF.param_defs(j_get_config(arch)))


def _setup(arch, seed=0):
    jcfg = j_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jp = JPM.init_params(JTF.param_defs(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32)),
        jp)
    return jcfg, tcfg, jp, TPM.params_from_jax(jp)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradient_match_jax(arch):
    """Logits and aux of a [2, 19] batch; the loss (ce + aux) and every
    leaf's gradient of one [2, 33] batch, router and experts included."""
    jcfg, tcfg, jp, tp = _setup(arch)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tcfg.vocab, (2, 19))
    want, jaux = jax.jit(JTF.forward, static_argnums=0)(
        jcfg, jp, jnp.asarray(tokens, jnp.int32))
    got, taux = TTF.forward(tcfg, tp, torch.from_numpy(tokens))
    close(got, want)
    assert float(jaux) > 0
    assert abs(float(taux) - float(jaux)) <= LOSS_TOL * float(jaux)

    toks = rng.integers(0, tcfg.vocab, (2, 33)).astype(np.int32)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: JTF.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(jp)
    leaves = _flat(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, met = TTF.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    for t in leaves.values():
        t.requires_grad_(False)
    for got_, want_ in ((loss, jloss), (met["ce"], jmet["ce"]),
                        (met["aux"], jmet["aux"])):
        assert abs(float(got_) - float(want_)) <= LOSS_TOL * abs(
            float(want_))
    jflat = _flat(jg)
    assert sorted(grads) == sorted(jflat)
    assert any("/moe/router" in k for k in grads)
    bad = {}
    for k, g in grads.items():
        w = np.asarray(jflat[k], np.float64)
        assert np.abs(w).max() > 0, k
        err = float(np.abs(g.numpy() - w).max() / np.abs(w).max())
        if not err <= GRAD_TOL:
            bad[k] = err
    assert not bad, bad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode_match_jax(arch, dtype):
    """Fused prefill (logits and every cache leaf of both segments), then
    4 decode steps fed JAX's greedy tokens: each step routes its B
    tokens with its own capacity; the logits at every step and the
    caches after the last."""
    jcfg, tcfg, jp, tp = _setup(arch, seed=2)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol, cache_tol = ((TOL, TOL) if dtype == "float32"
                      else (MOE_BF16_DECODE_TOL, BF16_CACHE_TOL))
    B, S, T, steps = 2, 11, 16, 4
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab, (B, S))
    jl, jc = jax.jit(JTF.prefill_cache, static_argnums=0)(
        jcfg, jp, jnp.asarray(tokens, jnp.int32),
        JTF.init_cache(jcfg, B, T, jdt))
    decode = jax.jit(JTF.decode_step, static_argnums=0)
    tl, tc = TTF.prefill_cache(tcfg, tp, torch.from_numpy(tokens),
                               TTF.init_cache(tcfg, B, T, tdt))
    close(tl, jl)

    def leaves_close(got, want):
        assert sorted(_flat(got)) == sorted(_flat(want))
        for k, g in _flat(got).items():
            assert g.dtype == tdt, k
            close(g, _flat(want)[k], cache_tol)
    leaves_close(tc, jc)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    for i in range(steps):
        jl, jc = decode(jcfg, jp, jc, jnp.asarray(tok, jnp.int32),
                        jnp.int32(S + i))
        tl, tc = TTF.decode_step(tcfg, tp, tc, torch.tensor(tok), S + i)
        close(tl, jl, tol)
        tok = np.asarray(jnp.argmax(jl.reshape(B, -1), axis=-1))[:, None]
    leaves_close(tc, jc)


def test_the_references_own_bfloat16_decode_spread_fits_the_limit():
    """The limit of the moe archs' decode logits over a bfloat16 cache is
    the reference's own spread: JAX's dbrx-132b-smoke decode, its weights
    moved by one ulp, against itself (up to 2.3e-3 of max|logit| over
    its 4 decode steps on the CPU; 1e-6 over a float32 cache)."""
    jcfg, _, jp, _ = _setup("dbrx-132b", seed=2)
    jp2 = jax.tree.map(lambda a: jnp.asarray(
        np.nextafter(np.asarray(a), np.float32(np.inf))), jp)
    B, S, T = 2, 11, 16
    tokens = jnp.asarray(np.random.default_rng(3).integers(
        0, jcfg.vocab, (B, S)), jnp.int32)
    prefill = jax.jit(JTF.prefill_cache, static_argnums=0)
    decode = jax.jit(JTF.decode_step, static_argnums=0)
    spread = {}
    for dt in ("float32", "bfloat16"):
        runs = []
        for p in (jp, jp2):
            lg, c = prefill(jcfg, p, tokens,
                            JTF.init_cache(jcfg, B, T, jnp.dtype(dt)))
            tok = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
            steps = []
            for i in range(4):
                lg, c = decode(jcfg, p, c, tok, jnp.int32(S + i))
                steps.append(np.asarray(lg, np.float64))
                tok = jnp.argmax(lg.reshape(B, -1), axis=-1)[:, None]
            runs.append(steps)
        spread[dt] = max(float(np.abs(a - b).max() / np.abs(a).max())
                         for a, b in zip(*runs))
    assert spread["float32"] <= TOL
    assert spread["bfloat16"] <= MOE_BF16_DECODE_TOL, spread


# ---------------------------------------------------------------------------
# MLA at deepseek-v2's head widths; B6's plain version at (192, 128)
# ---------------------------------------------------------------------------

MLA_SPEC = dict(kind="mla", n_heads=4, n_kv_heads=4, head_dim=192,
                q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=128,
                qk_rope_dim=64, v_head_dim=128, rope_theta=10_000.0)


def test_mla_layers_at_deepseek_v2_head_widths_match_jax(monkeypatch):
    """mla_attention over a [2, 21] sequence through B6's (192, 128) pair
    (its plain version here), scaled by the float32 1/sqrt(192); then
    mla_decode at per-slot positions over the float32 and the bfloat16
    latent cache the prefill wrote."""
    d, B, S, T = 64, 2, 21, 24
    a = tbase.AttentionSpec(**MLA_SPEC)
    ja = jbase.AttentionSpec(**MLA_SPEC)
    rng = np.random.default_rng(7)
    defs = TL.mla_defs(d, a)
    p = {k: (rng.normal(size=dd.shape)
             / np.sqrt(max(int(np.prod(dd.shape[:-1])), 1))).astype(
                 np.float32) for k, dd in defs.items()}
    for k in ("q_norm", "kv_norm"):
        p[k] = 1 + 0.1 * rng.normal(size=defs[k].shape).astype(np.float32)
    assert TL._mla_scale(a) == float(np.float32(1) / np.sqrt(
        np.float32(192)))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    seen = []
    real = ref.flash_attention_ref

    def spy(q, k, v, window=0):
        seen.append((q, k, v))
        return real(q, k, v, window)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    jout, (jc, jkr) = jax.jit(JL.mla_attention, static_argnums=1)(
        jp, ja, jnp.asarray(x), jnp.arange(S))
    monkeypatch.setattr(ref, "flash_attention_ref", spy)
    tout, (tc, tkr) = TL.mla_attention(tp, a, torch.from_numpy(x),
                                       torch.arange(S))
    monkeypatch.undo()
    q, k, v = seen[0]
    assert q.shape == k.shape == (B, 4, S, 192) and v.shape == (B, 4, S, 128)
    assert (192, 128) in fa_kern.SUPPORTED_PAIRS
    assert all(fa_kern.aligned(t) and t.stride(-1) == 1 for t in seen[0])
    close(tout, jout)
    close(tc, jc)
    close(tkr, jkr)
    for dt, tol in (("float32", TOL), ("bfloat16", MLA_BF16_TOL)):
        jcc = jnp.zeros((B, T, a.kv_lora_rank), dt).at[:, :S].set(
            jc.astype(dt))
        jck = jnp.zeros((B, T, a.qk_rope_dim), dt).at[:, :S].set(
            jkr.astype(dt))
        tcc = torch.from_numpy(np.asarray(jcc.astype(jnp.float32))).to(
            getattr(torch, dt))
        tck = torch.from_numpy(np.asarray(jck.astype(jnp.float32))).to(
            getattr(torch, dt))
        pos = np.array([S, S - 3])
        xn = rng.normal(size=(B, 1, d)).astype(np.float32)
        jo, (jcc, jck) = jax.jit(JL.mla_decode, static_argnums=1)(
            jp, ja, jnp.asarray(xn), jcc, jck, jnp.asarray(pos, jnp.int32))
        to, (tcc, tck) = TL.mla_decode(tp, a, torch.from_numpy(xn), tcc,
                                       tck, torch.from_numpy(pos))
        close(to, jo, tol)
        ctol = TOL if dt == "float32" else BF16_CACHE_TOL
        close(tcc.float(), jcc.astype(jnp.float32), ctol)
        close(tck.float(), jck.astype(jnp.float32), ctol)


def _attention64(q, k, v, window):
    """float64 einsum of causal (window) GQA attention, scale 1/sqrt(D)."""
    G = q.shape[1] // k.shape[1]
    kx, vx = (t.repeat_interleave(G, dim=1) for t in (k, v))
    s = torch.einsum("bhsd,bhtd->bhst", q, kx) / np.sqrt(q.shape[3])
    mask = ref.attention_mask(q.shape[2], k.shape[2], window, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, -1), vx)


@pytest.mark.parametrize("window", [0, 9])
def test_plain_attention_and_gradient_at_192_128(window):
    B, H, Hkv, S, D, Dv = 2, 4, 2, 37, 192, 128
    rng = np.random.default_rng(window)
    q, k, v, dO = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   for s in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, Dv),
                             (B, H, S, Dv)))
    got = ref.flash_attention_ref(q, k, v, window)
    assert got.shape == (B, H, S, Dv)
    close(got, _attention64(q.double(), k.double(), v.double(), window)
          .numpy(), 1e-5)
    grads = ref.flash_attention_grads_ref(q, k, v, dO, window)
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(_attention64(*leaves, window), leaves,
                               dO.double())
    for g, w, t in zip(grads, want, (q, k, v)):
        assert g.shape == t.shape
        close(g, w.numpy(), 1e-5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_kern.flash_attention(q, k, v)
