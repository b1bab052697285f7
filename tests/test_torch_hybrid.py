"""The port's mamba2 block (``models/mamba2.py``) and the hybrid segment
of ``models/transformer.py`` with its config, zamba2-2.7b, against the
JAX package on the same numpy inputs:

* ``_causal_conv``, ``_ssd_chunked``, ``mamba2_forward`` and
  ``mamba2_decode`` across chunk boundaries, a ragged S (the padding
  path), S below one chunk and a given conv state; the final state
  after padded steps.
* The masked exponent: the port's forward is bit-equal to its own
  ``where(mask, exp(li), 0)`` form.  At chunk 256 with S = 128 the
  reference's gradient of ``A_log``, ``dt_bias`` and ``w_dt`` is not
  finite (ROADMAP §C.5) while the port's is, and equals a float64
  sequential recurrence; at S = 64, where the reference's gradient is
  finite, the port's equals it.
* zamba2's config field by field, full and reduced, its parameter tree
  (the ``[units, sub, ...]`` stack, ``shared_attn`` after ``seg_0``) and
  its cache layout; at ``reduced()`` (4 layers in 2 units, chunk 32) the
  forward logits, the loss and every gradient leaf
  (``jax.value_and_grad``; the shared block's gradient sums over the
  units), remat, the fused prefill with every cache leaf and 4
  teacher-forced decode steps over a float32 and a bfloat16 cache; the
  serve loop and a checkpoint of the tree.

Tolerances (``test_torch_zoo.py``'s): logits within 1e-4 of the largest
|logit| and cache leaves within 1e-4 of their largest magnitude over a
float32 cache; over a bfloat16 cache the logits within 1e-3 and the
cache leaves within 2^-7 (one bfloat16 step); the loss within 1e-5
relative and each gradient leaf within 1e-4 of its largest |g|; the
block's pieces within 1e-5 of their largest magnitude.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as j_get_config
from repro.configs.base import SSMSpec as JSSMSpec
from repro.models import mamba2 as JM2
from repro.models import params as JPM
from repro.models import transformer as JTF
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import SSMSpec
from repro_torch.launch import serve
from repro_torch.models import mamba2 as TM2
from repro_torch.models import params as TPM
from repro_torch.models import transformer as TTF
from repro_torch.serving import ServeLoop

ARCH = "zamba2-2.7b"
TOL = 1e-4
BF16_TOL = 1e-3
BF16_CACHE_TOL = 2.0 ** -7
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
BLOCK_TOL = 1e-5

# the reference's functions, each compiled once per shape
J_CONV = jax.jit(JM2._causal_conv)
J_SSD = jax.jit(JM2._ssd_chunked, static_argnums=5)
J_FWD = jax.jit(JM2.mamba2_forward, static_argnums=1)
J_DEC = jax.jit(JM2.mamba2_decode, static_argnums=1)


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU work: one torch thread per test worker process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=TOL):
    got = np.asarray(torch.as_tensor(got).detach().float() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}/{k}"))
        return out
    return {path: tree}


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


# ---------------------------------------------------------------------------
# the block's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,with_state", [(12, False), (1, True),
                                          (7, True)])
def test_causal_conv_matches_jax(S, with_state):
    rng = np.random.default_rng(S)
    W, C = 4, 10
    x = rng.normal(size=(2, S, C)).astype(np.float32)
    kern = rng.normal(size=(W, C)).astype(np.float32)
    bias = rng.normal(size=(C,)).astype(np.float32)
    st = rng.normal(size=(2, W - 1, C)).astype(np.float32) \
        if with_state else None
    jo, js = J_CONV(jnp.asarray(x), jnp.asarray(kern),
                              jnp.asarray(bias),
                              None if st is None else jnp.asarray(st))
    to, ts = TM2._causal_conv(t(x), t(kern), t(bias),
                              None if st is None else t(st))
    close(to, jo, BLOCK_TOL)
    close(ts, js, BLOCK_TOL)


def test_causal_conv_promotes_a_bfloat16_state():
    """Decode concatenates a bfloat16 cached state with the float32
    input: the new state is float32 in both packages."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 1, 6)).astype(np.float32)
    kern, bias = (rng.normal(size=s).astype(np.float32) for s in ((4, 6),
                                                                   (6,)))
    st = rng.normal(size=(2, 3, 6)).astype(np.float32)
    jo, js = J_CONV(jnp.asarray(x), jnp.asarray(kern),
                              jnp.asarray(bias),
                              jnp.asarray(st, jnp.bfloat16))
    to, ts = TM2._causal_conv(t(x), t(kern), t(bias),
                              t(st).to(torch.bfloat16))
    assert js.dtype == jnp.float32 and ts.dtype == torch.float32
    close(to, jo, BLOCK_TOL)
    close(ts, js, BLOCK_TOL)


def _ssd_inputs(rng, B, S, H, P, N):
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.uniform(0.1, 0.9, size=(B, S, H)).astype(np.float32),
            rng.uniform(-1.0, -0.1, size=(H,)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32))


@pytest.mark.parametrize("S,chunk", [(16, 4), (20, 8), (7, 16), (32, 32),
                                     (45, 16), (64, 16)])
def test_ssd_chunked_matches_jax(S, chunk):
    """Whole chunks, a ragged S padded up to a multiple of the chunk
    (20 / 8, 45 / 16: the final state runs through the padded steps,
    dt = 0 there), S below one chunk (7 / 16: Q = S)."""
    ins = _ssd_inputs(np.random.default_rng(S + chunk), 2, S, 3, 4, 5)
    jy, js = J_SSD(*(jnp.asarray(a) for a in ins), chunk)
    ty, ts = TM2._ssd_chunked(*(t(a) for a in ins), chunk)
    assert ty.dtype == ts.dtype == torch.float32
    close(ty, jy, BLOCK_TOL)
    close(ts, js, BLOCK_TOL)


def _block_params(d, spec, seed):
    """JAX-initialised mamba2 params with the zero / one leaves moved
    off their init (dt_bias, A_log, D_skip, conv_b, gamma)."""
    jp = JPM.init_params(JM2.mamba2_defs(d, spec), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp = {k: jnp.asarray(np.asarray(v) + 0.1 * rng.normal(
        size=v.shape).astype(np.float32)) for k, v in jp.items()}
    return jp, TPM.params_from_jax(jp)


SPEC = dict(state_dim=8, head_dim=8, chunk=8, conv_width=4)


@pytest.mark.parametrize("S", [5, 8, 21])
def test_mamba2_forward_and_decode_match_jax(S):
    """The full-sequence forward (S below, at and past a chunk with a
    ragged tail) and its states, then 3 decode steps from them."""
    jspec, tspec = JSSMSpec(**SPEC), SSMSpec(**SPEC)
    d, B = 16, 2
    jp, tp = _block_params(d, jspec, S)
    rng = np.random.default_rng(100 + S)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    jy, (jconv, jssm) = J_FWD(jp, jspec, jnp.asarray(x))
    ty, (tconv, tssm) = TM2.mamba2_forward(tp, tspec, t(x))
    close(ty, jy, BLOCK_TOL)
    close(tconv, jconv, BLOCK_TOL)
    close(tssm, jssm, BLOCK_TOL)
    for _ in range(3):
        xn = rng.normal(size=(B, 1, d)).astype(np.float32)
        jy, (jconv, jssm) = J_DEC(jp, jspec, jnp.asarray(xn),
                                              jconv, jssm)
        ty, (tconv, tssm) = TM2.mamba2_decode(tp, tspec, t(xn), tconv, tssm)
        close(ty, jy, BLOCK_TOL)
        close(tconv, jconv, BLOCK_TOL)
        close(tssm, jssm, BLOCK_TOL)


def test_forward_from_a_given_conv_state_matches_jax():
    jspec, tspec = JSSMSpec(**SPEC), SSMSpec(**SPEC)
    d = 16
    jp, tp = _block_params(d, jspec, 3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 11, d)).astype(np.float32)
    st = rng.normal(size=(2, 3, 2 * d + 16)).astype(np.float32)
    jy, (jconv, jssm) = J_FWD(jp, jspec, jnp.asarray(x),
                                           jnp.asarray(st))
    ty, (tconv, tssm) = TM2.mamba2_forward(tp, tspec, t(x), t(st))
    close(ty, jy, BLOCK_TOL)
    close(tconv, jconv, BLOCK_TOL)
    close(tssm, jssm, BLOCK_TOL)


# ---------------------------------------------------------------------------
# the masked exponent
# ---------------------------------------------------------------------------

def _where_form(cum):
    """The reference's form: exp of the whole block, masked after."""
    Q = cum.shape[-1]
    li = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool).tril()
    return torch.where(mask, torch.exp(li), torch.zeros_like(li))


@pytest.mark.parametrize("S,chunk", [(21, 8), (128, 256), (300, 256)])
def test_masked_exponent_leaves_the_forward_bit_equal(S, chunk,
                                                      monkeypatch):
    """The port's forward and states against its own where form: the
    same bits (the masking moves no value), at zamba2's chunk of 256
    too, where exp(li) above the diagonal is inf."""
    spec = SSMSpec(state_dim=16, head_dim=32, chunk=chunk)
    d = 64
    _, tp = _block_params(d, JSSMSpec(state_dim=16, head_dim=32,
                                      chunk=chunk), 5)
    x = t(np.random.default_rng(6).normal(size=(1, S, d)))
    got = TM2.mamba2_forward(tp, spec, x)
    monkeypatch.setattr(TM2, "_intra_decay", _where_form)
    want = TM2.mamba2_forward(tp, spec, x)
    for a, b in ((got[0], want[0]), (got[1][0], want[1][0]),
                 (got[1][1], want[1][1])):
        assert torch.equal(a, b)


def _rms64(x, gamma, eps=1e-5):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * gamma


def _mamba2_sequential64(p, s, x):
    """float64 oracle of mamba2_forward: the SSM as its per-token
    recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_tᵀ, y_t = C_t h_t."""
    di, H = TM2.dims(x.shape[-1], s)
    N, Pd = s.state_dim, di // H
    B, S, _ = x.shape
    z = x @ p["w_z"]
    xbc = torch.cat([x @ p["w_x"], x @ p["w_B"], x @ p["w_C"]], -1)
    xbc, _ = TM2._causal_conv(xbc, p["conv_k"], p["conv_b"])
    xbc = torch.nn.functional.silu(xbc)
    xc, Bc, Cc = torch.split(xbc, [di, N, N], -1)
    dt = torch.nn.functional.softplus(x @ p["w_dt"] + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xc.reshape(B, S, H, Pd)
    h = torch.zeros((B, H, N, Pd), dtype=x.dtype)
    ys = []
    for i in range(S):
        h = (h * torch.exp(dt[:, i] * A)[:, :, None, None]
             + Bc[:, i, None, :, None]
             * (dt[:, i, :, None] * xh[:, i])[:, :, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", Cc[:, i], h))
    y = torch.stack(ys, 1) + p["D_skip"][:, None] * xh
    y = _rms64(y.reshape(B, S, di) * torch.nn.functional.silu(z),
               p["gamma"])
    return y @ p["w_out"]


def _block_grads(S, chunk):
    """The reference's gradient (jax.grad) and the port's (autograd) of
    sum(out * probe) over the block's params, at d 256, head 32, state
    16 with JAX's seeded init, on an input of unit RMS (the model feeds
    the block rms_norm(x))."""
    jspec = JSSMSpec(state_dim=16, head_dim=32, chunk=chunk)
    tspec = SSMSpec(state_dim=16, head_dim=32, chunk=chunk)
    d = 256
    jp = JPM.init_params(JM2.mamba2_defs(d, jspec), jax.random.PRNGKey(0))
    rng = np.random.default_rng(S)
    x = rng.normal(size=(1, S, d)).astype(np.float32)
    probe = rng.normal(size=(1, S, d)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(JM2.mamba2_forward(
        p, jspec, jnp.asarray(x))[0] * probe)))(jp)
    tp = {k: t(np.asarray(v)).requires_grad_(True) for k, v in jp.items()}
    out = TM2.mamba2_forward(tp, tspec, t(x))[0]
    tg = dict(zip(tp, torch.autograd.grad((out * t(probe)).sum(),
                                          list(tp.values()))))
    return jp, jg, tg, tspec, x, probe


def test_port_gradient_is_finite_where_the_references_is_not():
    """Chunk 256, S = 128: dt ≈ 0.7 a token, so cum_i - cum_j above the
    diagonal reaches ~90 and exp overflows.  The reference's gradient
    of A_log, dt_bias and w_dt is non-finite; the port's is finite
    everywhere and equals the float64 sequential recurrence's."""
    jp, jg, tg, tspec, x, probe = _block_grads(128, 256)
    for k in ("A_log", "dt_bias", "w_dt"):
        assert not np.isfinite(np.asarray(jg[k])).all(), k
    p64 = {k: torch.from_numpy(np.asarray(v, np.float64)).requires_grad_(
        True) for k, v in jp.items()}
    out = _mamba2_sequential64(p64, tspec,
                               torch.from_numpy(x.astype(np.float64)))
    want = dict(zip(p64, torch.autograd.grad(
        (out * torch.from_numpy(probe.astype(np.float64))).sum(),
        list(p64.values()))))
    for k, g in tg.items():
        assert torch.isfinite(g).all(), k
        close(g, want[k].numpy(), GRAD_TOL)


def test_port_gradient_equals_the_reference_where_it_is_finite():
    """Chunk 256, S = 64: the reference's gradient is finite, and the
    port's equals it leaf by leaf."""
    _, jg, tg, *_ = _block_grads(64, 256)
    for k, g in tg.items():
        assert np.isfinite(np.asarray(jg[k])).all(), k
        close(g, jg[k], GRAD_TOL)


# ---------------------------------------------------------------------------
# zamba2: the config, the trees, the model at reduced()
# ---------------------------------------------------------------------------

def test_config_is_the_jax_config_field_by_field():
    for reduce in (False, True):
        jc, tc = j_get_config(ARCH), get_config(ARCH)
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        for f in dataclasses.fields(jc):
            assert dataclasses.asdict(tc)[f.name] == \
                dataclasses.asdict(jc)[f.name], (reduce, f.name)
        assert ([tuple(s) for s in TTF.segments(tc)]
                == [tuple(s) for s in JTF.segments(jc)])
    assert TPM.count_params(TTF.param_defs(get_config(ARCH))) == \
        JPM.count_params(JTF.param_defs(j_get_config(ARCH))) == 2_422_670_240


def test_param_tree_and_cache_layout_are_the_references():
    """The [units, sub, ...] stack under seg_0 and shared_attn after it
    in sorted key order (so a flattened gradient lines up with the
    reference's tree_to_vec); the fan-in of a stacked leaf excludes
    units and sub; the cache's shapes and logical axes."""
    cfg, jcfg = get_config(ARCH).reduced(), j_get_config(ARCH).reduced()
    tdefs, jdefs = TTF.param_defs(cfg), JTF.param_defs(jcfg)
    assert sorted(tdefs) == ["embed", "final_norm", "lm_head", "seg_0",
                             "shared_attn"]
    got = {k: (d.shape, d.axes) for k, d in _flat(tdefs).items()}
    want = {k: (d.shape, d.axes) for k, d in _flat(jdefs).items()}
    assert got == want
    assert got["/seg_0/m/w_x"] == ((2, 2, 256, 512),
                                   ("units", "sub", "embed", "inner"))
    mine = TPM.init_params(tdefs, torch.Generator().manual_seed(0))
    w = mine["seg_0"]["m"]["w_x"]
    assert abs(float(w.std()) * np.sqrt(256) - 1.0) < 0.05
    tc = TTF.cache_defs(cfg, 3, 20)
    jc = JTF.cache_defs(jcfg, 3, 20)
    assert tc == jc
    assert tc["seg_0"]["mamba"]["conv"][0] == (2, 2, 3, 3, 512 + 32)
    with pytest.raises(ValueError, match="multiple"):
        TTF.segments(dataclasses.replace(cfg, n_layers=5))


def _setup(seed=0):
    jcfg = j_get_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    jp = JPM.init_params(JTF.param_defs(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32)),
        jp)
    return jcfg, tcfg, jp, TPM.params_from_jax(jp)


def _grads(tcfg, tp, batch, remat=False):
    leaves = _flat(tp)
    for x in leaves.values():
        x.requires_grad_(True)
    loss, _ = TTF.loss_fn(tcfg, tp, batch, remat=remat)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    for x in leaves.values():
        x.requires_grad_(False)
    return float(loss.detach()), grads


def test_loss_and_gradient_match_jax():
    """The loss and every leaf's gradient of one [2, 45] batch (two
    32-token chunks, the second ragged), the shared block's gradient
    summed over the 2 units; remat (one checkpoint a unit) gives the
    same loss and gradients.  (The forward logits are held in the
    prefill test, against the reference's prefill.)"""
    jcfg, tcfg, jp, tp = _setup()
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab, (2, 45)).astype(np.int32)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JTF.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(jp)
    batch = {"tokens": torch.from_numpy(toks)}
    loss, grads = _grads(tcfg, tp, batch)
    assert abs(loss - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    jflat = _flat(jg)
    assert sorted(grads) == sorted(jflat)
    assert "/shared_attn/attn/wq" in grads and "/seg_0/m/A_log" in grads
    bad = {}
    for k, g in grads.items():
        w = np.asarray(jflat[k], np.float64)
        assert np.abs(w).max() > 0, k
        err = float(np.abs(g.numpy() - w).max() / np.abs(w).max())
        if not err <= GRAD_TOL:
            bad[k] = err
    assert not bad, bad
    rloss, rgrads = _grads(tcfg, tp, batch, remat=True)
    assert rloss == loss
    for k in grads:
        close(rgrads[k], grads[k].numpy(), 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_teacher_forced_decode_match_jax(dtype):
    """Fused prefill over 37 tokens (a 32-token chunk and a ragged tail):
    the logits (and the port's forward's) and every cache leaf (the
    mamba states of each unit's blocks, the shared block's K/V per
    unit); then 4 decode steps fed
    JAX's greedy tokens: the logits at every step and the caches after
    the last.  The port keeps ``conv`` in float32 (the reference's
    decode returns it so); its prefill value is rounded through the
    cache dtype, as the reference stores it."""
    jcfg, tcfg, jp, tp = _setup(seed=2)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol, cache_tol = ((TOL, TOL) if dtype == "float32"
                      else (BF16_TOL, BF16_CACHE_TOL))
    B, S, T, steps = 2, 37, 44, 4
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab, (B, S))
    jl, jc = jax.jit(JTF.prefill_cache, static_argnums=0)(
        jcfg, jp, jnp.asarray(tokens, jnp.int32),
        JTF.init_cache(jcfg, B, T, jdt))
    decode = jax.jit(JTF.decode_step, static_argnums=0)
    cache = TTF.init_cache(tcfg, B, T, tdt)
    bufs = {k: v.data_ptr() for k, v in _flat(cache).items()}
    tl, tc = TTF.prefill_cache(tcfg, tp, torch.from_numpy(tokens), cache)
    close(tl, jl)
    close(TTF.forward(tcfg, tp, torch.from_numpy(tokens))[0], jl)

    def leaves_close(got, want):
        assert sorted(_flat(got)) == sorted(_flat(want))
        for k, g in _flat(got).items():
            assert g.dtype == (torch.float32 if k.endswith("/conv")
                               else tdt), k
            assert g.data_ptr() == bufs[k], k      # written in place
            close(g, np.asarray(_flat(want)[k], np.float32), cache_tol)
    leaves_close(tc, jc)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    for i in range(steps):
        jl, jc = decode(jcfg, jp, jc, jnp.asarray(tok, jnp.int32),
                        jnp.int32(S + i))
        tl, tc = TTF.decode_step(tcfg, tp, tc, torch.tensor(tok), S + i)
        close(tl, jl, tol)
        tok = np.asarray(jnp.argmax(jl.reshape(B, -1), axis=-1))[:, None]
    leaves_close(tc, jc)


def test_serve_loop_tokens_equal_each_requests_own_decode():
    """ServeLoop on the CPU (eager steps) at 3 slots for 5 requests of
    ragged lengths: every request's tokens equal its batch-1
    serve.generate decode (exact prefill, the mamba states and the
    shared block's K/V of a used slot written over)."""
    _, tcfg, _, tp = _setup(seed=4)
    loop = ServeLoop(tcfg, 3, 24, params=tp)
    rng = np.random.RandomState(0)
    stream = [(rng.randint(0, tcfg.vocab, size=rng.randint(5, 14)), 6)
              for _ in range(5)]
    for prompt, gen in stream:
        loop.submit(prompt, gen)
    done = loop.run()
    assert loop.prefill_shapes() == len({len(p) for p, _ in stream})
    for rid, (prompt, gen) in enumerate(stream):
        want = serve.generate(tcfg, tp, torch.from_numpy(
            prompt.astype(np.int64))[None], gen, 24)[0][0].numpy()
        np.testing.assert_array_equal(done[rid], want)


def test_checkpoint_of_the_tree_restores_in_jax_bitexact(tmp_path):
    """The [units, sub, ...] leaves and shared_attn through the port's
    checkpoint into the JAX package's restore, bit for bit."""
    jcfg, _, jp, tp = _setup(seed=5)
    d = str(tmp_path)
    ckpt.save(d, tp, step=4)
    got, step = jckpt.restore(d, like=jp)
    assert step == 4
    for (kp, j), (_, g) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(jp)[0]):
        assert np.array_equal(np.asarray(j), np.asarray(g)), kp
    with open(os.path.join(d, "step_00000004.json")) as f:
        keys = json.load(f)["keys"]
    assert "seg_0/m/w_x" in keys and "shared_attn/mlp/w_gate" in keys
