"""The dense zoo configs the port added after qwen3-0.6b — qwen3-1.7b,
nemotron-4-15b (untied head, ungated squared-ReLU MLP) and minicpm3-4b
(MLA attention) — against the JAX package on the same numpy inputs:

* the config copies field by field, full and reduced;
* at 2 reduced layers (float32, JAX weights perturbed by seeded noise
  and carried across by ``params_from_jax``): the forward logits, the
  loss and its gradient over every leaf (``jax.value_and_grad``), the
  fused prefill with every cache leaf and 4 teacher-forced decode steps
  over a float32 and a bfloat16 cache;
* MLA's layers at minicpm3's head widths (q/k 96, v 64) with a narrow
  model width: the full-sequence form through ``ops.flash_attention``
  and the weight-absorbed decode, and the views it hands B6;
* B6's plain version and its gradient at unequal widths (96, 64) and
  the reduced MLA widths (48, 32) against a float64 einsum, and the
  wrapper's refusal of a (D, Dv) pair without a kernel instance.

Tolerances: logits within 1e-4 of the largest |logit| and cache leaves
within 1e-4 of their largest magnitude over a float32 cache (the plain
B6 sums in another order than the reference's einsums); over a bfloat16
cache the logits within 1e-3 (ROADMAP §C.4: a value rounded to bfloat16
from float32 inputs that differ in their last bits can land one
bfloat16 step apart) and the cache leaves within 2^-7 of their largest
magnitude (one bfloat16 step); the loss within 1e-5 relative and each
gradient leaf within 1e-4 of its largest |g| (``test_torch_grad.py``'s
limits); the plain attention within 1e-5 of float64.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro.models import params as JPM
from repro.models import transformer as JTF
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa_kern
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL
from repro_torch.models import params as TPM
from repro_torch.models import transformer as TTF

ARCHS = ("qwen3-1.7b", "nemotron-4-15b", "minicpm3-4b")
TOL = 1e-4
BF16_TOL = 1e-3
BF16_CACHE_TOL = 2.0 ** -7
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def close(got, want, rtol=TOL):
    got = np.asarray(torch.as_tensor(got).float() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _setup(arch, seed=0):
    jcfg = j_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jp = JPM.init_params(JTF.param_defs(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32)),
        jp)
    return jcfg, tcfg, jp, TPM.params_from_jax(jp)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}/{k}"))
        return out
    return {path: tree}


# ---------------------------------------------------------------------------
# the configs
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
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    cfg = get_config(arch)
    defs = TTF.param_defs(cfg)
    assert TPM.count_params(defs) == JPM.count_params(
        JTF.param_defs(j_get_config(arch)))
    assert ("lm_head" in defs) == (not cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# the model at 2 reduced layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradient_match_jax(arch):
    """Logits of a [2, 19] batch; the loss and every leaf's gradient of
    one [2, 33] batch (qwen3's tied embedding takes its gradient from
    the lookup and the head; nemotron's head is its own leaf)."""
    jcfg, tcfg, jp, tp = _setup(arch)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tcfg.vocab, (2, 19))
    want, _ = JTF.forward(jcfg, jp, jnp.asarray(tokens, jnp.int32))
    close(TTF.forward(tcfg, tp, torch.from_numpy(tokens))[0], want)

    toks = rng.integers(0, tcfg.vocab, (2, 33)).astype(np.int32)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JTF.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(jp)
    leaves = _flat(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, aux = TTF.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    for t in leaves.values():
        t.requires_grad_(False)
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    jflat = _flat(jg)
    assert sorted(grads) == sorted(jflat)
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
    """Fused prefill (logits and every cache leaf: MLA's latent ``c`` and
    rope key ``kr``), then 4 decode steps fed JAX's greedy tokens: the
    logits at every step and the caches after the last."""
    jcfg, tcfg, jp, tp = _setup(arch, seed=2)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol, cache_tol = ((TOL, TOL) if dtype == "float32"
                      else (BF16_TOL, BF16_CACHE_TOL))
    B, S, T, steps = 2, 11, 16, 4
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab, (B, S))
    jl, jc = JTF.prefill_cache(jcfg, jp, jnp.asarray(tokens, jnp.int32),
                               JTF.init_cache(jcfg, B, T, jdt))
    tl, tc = TTF.prefill_cache(tcfg, tp, torch.from_numpy(tokens),
                               TTF.init_cache(tcfg, B, T, tdt))
    close(tl, jl)

    def leaves_close(got, want):
        assert sorted(_flat(got)) == sorted(_flat(want))
        for k, g in _flat(got).items():
            assert g.dtype == tdt, k
            close(g, _flat(want)[k], cache_tol)
    leaves_close(tc, jc)
    if tcfg.attention.kind == "mla":
        assert sorted(tc["seg_0"]) == ["c", "kr"]
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    for i in range(steps):
        jl, jc = JTF.decode_step(jcfg, jp, jc, jnp.asarray(tok, jnp.int32),
                                 jnp.int32(S + i))
        tl, tc = TTF.decode_step(tcfg, tp, tc, torch.tensor(tok), S + i)
        close(tl, jl, tol)
        tok = np.asarray(jnp.argmax(jl.reshape(B, -1), axis=-1))[:, None]
    leaves_close(tc, jc)


# ---------------------------------------------------------------------------
# MLA at minicpm3-4b's head widths
# ---------------------------------------------------------------------------

MLA_SPEC = dict(kind="mla", n_heads=4, n_kv_heads=4, head_dim=96,
                q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=64,
                qk_rope_dim=32, v_head_dim=64, rope_theta=10_000.0)


def _mla_params(d, seed):
    a = tbase.AttentionSpec(**MLA_SPEC)
    rng = np.random.default_rng(seed)
    defs = TL.mla_defs(d, a)
    p = {k: (rng.normal(size=dd.shape)
             / np.sqrt(max(int(np.prod(dd.shape[:-1])), 1))).astype(
                 np.float32)
         for k, dd in defs.items()}
    p["q_norm"] = 1 + 0.1 * rng.normal(size=defs["q_norm"].shape).astype(
        np.float32)
    p["kv_norm"] = 1 + 0.1 * rng.normal(size=defs["kv_norm"].shape).astype(
        np.float32)
    return a, p


def test_mla_layers_at_minicpm3_head_widths_match_jax():
    """mla_attention over a [2, 21] sequence (B6's (96, 64) pair through
    its plain version), then mla_decode at per-slot positions over the
    bfloat16 latent cache the prefill wrote (the weights and the context
    rounded to bfloat16 as in the reference)."""
    d, B, S, T = 64, 2, 21, 24
    a, p = _mla_params(d, seed=7)
    ja = j_get_config("minicpm3-4b").attention.__class__(**MLA_SPEC)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    jout, (jc, jkr) = JL.mla_attention(jp, ja, jnp.asarray(x), jnp.arange(S))
    tout, (tc, tkr) = TL.mla_attention(tp, a, torch.from_numpy(x),
                                       torch.arange(S))
    close(tout, jout)
    close(tc, jc)
    close(tkr, jkr)
    for dt, tol in (("float32", TOL), ("bfloat16", BF16_TOL)):
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
        jo, (jcc, jck) = JL.mla_decode(jp, ja, jnp.asarray(xn), jcc, jck,
                                       jnp.asarray(pos, jnp.int32))
        to, (tcc, tck) = TL.mla_decode(tp, a, torch.from_numpy(xn), tcc,
                                       tck, torch.from_numpy(pos))
        close(to, jo, tol)
        close(tcc.float(), jcc.astype(jnp.float32),
              TOL if dt == "float32" else BF16_CACHE_TOL)
        close(tck.float(), jck.astype(jnp.float32),
              TOL if dt == "float32" else BF16_CACHE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_hands_b6_aligned_views_at_96_64(dtype, monkeypatch):
    """mla_attention makes one ops.flash_attention call with q, k [B,H,S,
    96] and v [B,H,S,64]: views whose head dimension is contiguous and
    whose rows start on 16 bytes, the pair of an instance; the output
    comes back [B,S,d]."""
    seen = []
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, window=0: seen.append((q, k, v))
                        or ref.flash_attention_ref(q, k, v, window))
    a, p = _mla_params(32, seed=9)
    tp = {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}
    x = torch.randn(2, 7, 32, generator=torch.Generator().manual_seed(1))
    out, _ = TL.mla_attention(tp, a, x.to(dtype), torch.arange(7))
    assert out.shape == (2, 7, 32)
    assert len(seen) == 1
    q, k, v = seen[0]
    assert q.shape == k.shape == (2, 4, 7, 96) and v.shape == (2, 4, 7, 64)
    assert (q.shape[3], v.shape[3]) in fa_kern.SUPPORTED_PAIRS
    for tensor in seen[0]:
        assert tensor.dtype == dtype and tensor.stride(-1) == 1
        assert fa_kern.aligned(tensor)


# ---------------------------------------------------------------------------
# B6's plain version and its gradient at unequal widths; the wrapper
# ---------------------------------------------------------------------------

def _attention64(q, k, v, window):
    """float64 einsum of causal (window) GQA attention, scale 1/sqrt(D)."""
    G = q.shape[1] // k.shape[1]
    kx, vx = (t.repeat_interleave(G, dim=1) for t in (k, v))
    s = torch.einsum("bhsd,bhtd->bhst", q, kx) / np.sqrt(q.shape[3])
    mask = ref.attention_mask(q.shape[2], k.shape[2], window, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, -1), vx)


@pytest.mark.parametrize("D,Dv", [(96, 64), (48, 32)])
@pytest.mark.parametrize("window", [0, 9])
def test_plain_attention_and_gradient_at_unequal_widths(D, Dv, window):
    B, H, Hkv, S = 2, 4, 2, 37
    rng = np.random.default_rng(D + window)
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


def test_wrapper_refuses_a_pair_without_an_instance():
    """The pairs with a kernel instance; any other (D, Dv) raises before
    the device is looked at, a listed pair on the CPU names the plain
    path."""
    assert fa_kern.SUPPORTED_PAIRS == ((64, 64), (80, 80), (96, 96),
                                       (128, 128), (96, 64), (192, 128))
    for D, Dv in ((112, 112), (48, 32), (64, 32), (128, 64), (192, 192)):
        q = torch.zeros(1, 2, 8, D)
        with pytest.raises(ValueError, match="no kernel instance"):
            fa_kern.flash_attention(q, q, torch.zeros(1, 2, 8, Dv))
    q = torch.zeros(1, 2, 8, 96)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_kern.flash_attention(q, q, torch.zeros(1, 2, 8, 64))
    with pytest.raises(ValueError, match="needs k"):
        fa_kern.flash_attention(q, q, torch.zeros(1, 2, 7, 64))
