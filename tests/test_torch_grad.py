"""The port's LM training loss and its gradient against the JAX package
(CPU; the plain versions of B6 and B7, which autograd differentiates):

* ``TokenStream`` and ``LMWorkerPipeline`` give the JAX ones' tokens,
  with and without the label_flip data attack;
* ``TF.loss_fn`` and its gradient over every parameter equal
  ``jax.value_and_grad(TF.loss_fn)`` at qwen3-0.6b-smoke and
  rwkv6-7b-smoke (2 layers, d = 256, float32, weights carried across by
  ``params_from_jax``), with and without a loss mask;
* ``remat=True`` gives the same loss and gradients as ``remat=False``;
* the plain B6 / B7 gradients (``ref.flash_attention_grads_ref``,
  ``ref.wkv6_seq_grads_plain``) equal JAX autodiff of ``_sdpa`` /
  ``_wkv_chunked``, also where the clamps of the chunked form bite;
* every C entry of every kernel library is declared with its arity,
  and the training wrappers refuse what their kernels cannot take.

Tolerances: the loss within 1e-5 relative; each gradient leaf within
1e-4 of that leaf's largest |g| (the plain versions sum in another
order than the JAX model's einsums and scan); the kernel-level
gradients within 2e-5 of their largest magnitude.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ByzantineConfig as JByz
from repro.data import pipeline as JPL
from repro.data.synthetic import TokenStream as JTokenStream
from repro.models import layers as JL
from repro.models import params as JPM
from repro.models import rwkv6 as JR6
from repro.models import transformer as JTF
from repro_torch.configs import get_config
from repro_torch.configs.base import ByzantineConfig
from repro_torch.data import pipeline as PL
from repro_torch.data.synthetic import TokenStream
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as fa_kern
from repro_torch.kernels import wkv6 as wkv_kern
from repro_torch.models import params as TPM
from repro_torch.models import transformer as TTF

ARCHS = ("qwen3-0.6b", "rwkv6-7b")
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
KERNEL_GRAD_TOL = 2e-5


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}/{k}"))
        return out
    return {path: tree}


@pytest.mark.parametrize("seed,step,batch,seq_len",
                         [(0, 0, 4, 16), (3, 7, 6, 33), (11, 2, 1, 1)])
def test_token_stream_matches_jax(seed, step, batch, seq_len):
    for vocab in (512, 151936):
        got = TokenStream(vocab, seed=seed).batch(step, batch, seq_len)
        want = JTokenStream(vocab, seed=seed).batch(step, batch, seq_len)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("attack", ["none", "label_flip", "scale"])
def test_lm_worker_pipeline_matches_jax(attack):
    """The prefix membership (the paper's): the port's keyed policies
    draw from torch generators, not JAX keys (see the next test)."""
    kw = dict(attack=attack, alpha=0.25 if attack != "none" else 0.0)
    for arch in ARCHS:
        pipe = PL.LMWorkerPipeline(get_config(arch).reduced(), 8, 2, 21,
                                   seed=5, byz=ByzantineConfig(**kw))
        jpipe = JPL.LMWorkerPipeline(j_get_config(arch).reduced(), 8, 2, 21,
                                     seed=5, byz=JByz(**kw))
        for step in (0, 3):
            got, want = pipe.batch(step), jpipe.batch(step)
            assert sorted(got) == sorted(want) == ["tokens"]
            assert got["tokens"].shape == (8, 2, 21)
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
    clean = PL.LMWorkerPipeline(get_config(ARCHS[0]).reduced(), 8, 2, 21,
                                seed=5).batch(0)["tokens"]
    flipped = (attack == "label_flip")
    assert (not np.array_equal(clean, pipe.batch(0)["tokens"])) == flipped


def test_lm_worker_pipeline_resample_corrupts_the_drawn_workers():
    cfg = get_config(ARCHS[1]).reduced()
    byz = ByzantineConfig(attack="label_flip", alpha=0.25,
                          membership="resample", byz_seed=3)
    pipe = PL.LMWorkerPipeline(cfg, 8, 2, 9, seed=1, byz=byz)
    clean = PL.LMWorkerPipeline(cfg, 8, 2, 9, seed=1)
    masks = []
    for step in range(4):
        mask = PL.threat.data_membership(byz, 8, step)
        got, want = pipe.batch(step)["tokens"], clean.batch(step)["tokens"]
        np.testing.assert_array_equal(got[~mask], want[~mask])
        np.testing.assert_array_equal(got[mask], cfg.vocab - 1 - want[mask])
        assert mask.sum() == 2
        masks.append(mask)
    assert any(not np.array_equal(masks[0], m) for m in masks[1:])


def _setup(arch, seed=0):
    jcfg = j_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jp = JPM.init_params(JTF.param_defs(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32)),
        jp)
    return jcfg, tcfg, jp, TPM.params_from_jax(jp)


def _leaf_grads(tcfg, tp, batch, remat=False):
    leaves = _flat(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, aux = TTF.loss_fn(tcfg, tp, batch, remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for t in leaves.values():
        t.requires_grad_(False)
    return loss.detach(), aux, dict(zip(leaves, grads))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_gradient_match_jax(arch, masked):
    """One worker's batch from LMWorkerPipeline (S = 70: two rwkv chunks,
    the second ragged); every parameter leaf's gradient, the tied
    embedding's two sources included."""
    jcfg, tcfg, jp, tp = _setup(arch)
    toks = PL.LMWorkerPipeline(tcfg, 2, 2, 70, seed=1).batch(0)["tokens"][0]
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks)}
    if masked:
        mask = np.random.default_rng(4).integers(0, 2, toks.shape)
        mask = mask.astype(np.float32)
        jbatch["loss_mask"] = jnp.asarray(mask)
        tbatch["loss_mask"] = torch.from_numpy(mask)
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: JTF.loss_fn(jcfg, p, jbatch), has_aux=True))(jp)
    loss, aux, grads = _leaf_grads(tcfg, tp, tbatch)
    assert sorted(aux) == ["aux", "ce"] and float(aux["aux"]) == 0.0
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert abs(float(aux["ce"].detach()) - float(jaux["ce"])) <= (
        LOSS_TOL * abs(float(jaux["ce"])))
    jflat = _flat(jg)
    assert sorted(grads) == sorted(jflat)
    worst = {k: _rel_err(grads[k], jflat[k]) for k in grads}
    bad = {k: e for k, e in worst.items() if not e <= GRAD_TOL}
    assert not bad, bad
    assert all(np.abs(np.asarray(jflat[k])).max() > 0 for k in jflat)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    _, tcfg, _, tp = _setup(arch, seed=3)
    toks = PL.LMWorkerPipeline(tcfg, 1, 2, 40, seed=2).batch(1)["tokens"][0]
    batch = {"tokens": torch.from_numpy(toks)}
    l0, _, g0 = _leaf_grads(tcfg, tp, batch, remat=False)
    l1, _, g1 = _leaf_grads(tcfg, tp, batch, remat=True)
    assert torch.equal(l0, l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=1e-6 * float(
            g0[k].abs().max()), msg=k)


def _sdpa_grads_jax(q, k, v, dO, window):
    """JAX autodiff of the model's _sdpa; [B,H,S,D] in and out."""
    S, T = q.shape[2], k.shape[2]
    mask = JL._causal_window_mask(S, T, window)[None, None, None]
    f = lambda a, b, c: JL._sdpa(a, b, c, mask)             # noqa: E731
    t = lambda x: jnp.asarray(np.asarray(x).transpose(0, 2, 1, 3))  # noqa
    grads = jax.jit(lambda *x: jax.vjp(f, *x[:3])[1](x[3]))(
        t(q), t(k), t(v), t(dO))
    return [np.asarray(g).transpose(0, 2, 1, 3) for g in grads]


@pytest.mark.parametrize("B,H,Hkv,S,D,window",
                         [(2, 4, 2, 33, 64, 0), (1, 8, 1, 40, 32, 7),
                          (1, 2, 2, 5, 16, 0)])
def test_plain_attention_gradient_matches_jax_sdpa(B, H, Hkv, S, D, window):
    rng = np.random.default_rng(S)
    q, dO = (torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, Hkv, S, D)).astype(
        np.float32)) for _ in range(2))
    got = ref.flash_attention_grads_ref(q, k, v, dO, window)
    want = _sdpa_grads_jax(q, k, v, dO, window)
    for name, a, b in zip("qkv", got, want):
        assert _rel_err(a, b) <= KERNEL_GRAD_TOL, name


def _wkv_inputs(B, S, H, K, decay, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)    # noqa: E731
    r, k, v = f(B, S, H, K), f(B, S, H, K), f(B, S, H, K)
    w = np.exp(-decay * rng.random((B, S, H, K))).astype(np.float32)
    return r, k, v, w, f(H, K), f(B, H, K, K), f(B, S, H, K), f(B, H, K, K)


@pytest.mark.parametrize("S,chunk,decay", [(70, 64, 1.0), (64, 64, 3.0),
                                           (9, 64, 1.0), (50, 16, 12.0)])
def test_plain_wkv_gradient_matches_jax_wkv_chunked(S, chunk, decay):
    """decay 12 over 16-token chunks: the cumulative log-decay reaches
    ~-190, so the ±40 clips and the -80 floors bite."""
    r, k, v, w, u, S0, dy, dSf = _wkv_inputs(2, S, 2, 16, decay, S)
    if decay > 10:
        assert (np.cumsum(np.log(w[:, :chunk]), axis=1).min() < -80)
    got = ref.wkv6_seq_grads_plain(*(torch.from_numpy(x) for x in (
        r, k, v, w, u, S0)), chunk, torch.from_numpy(dy),
        torch.from_numpy(dSf))
    f = lambda *x: JR6._wkv_chunked(*x, chunk)              # noqa: E731
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (r, k, v, w, u, S0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dSf)))
    for name, a, b in zip(("r", "k", "v", "w", "u", "S_in"), got, want):
        assert _rel_err(a, b) <= KERNEL_GRAD_TOL, name


def test_ops_on_cpu_take_the_plain_version_under_autograd():
    """A CPU tensor that requires grad goes to the plain version (no
    Function, no launch) and autograd differentiates it."""
    ops.reset_launches()
    r, k, v, w, u, S0, dy, _ = _wkv_inputs(1, 20, 2, 32, 1.0, 0)
    ins = [torch.from_numpy(x).requires_grad_(True)
           for x in (r, k, v, w, u, S0)]
    y, _ = ops.wkv6_seq(*ins, 64)
    y.backward(torch.from_numpy(dy))
    want = ref.wkv6_seq_grads_plain(*(x.detach() for x in ins), 64,
                                    torch.from_numpy(dy))
    for x, g in zip(ins, want):
        torch.testing.assert_close(x.grad, g, rtol=0, atol=0)
    assert set(ops.launches().values()) == {0}
    assert set(ops.copies().values()) == {0}
    assert {"flash_attention_bwd", "wkv6_seq_bwd"} <= set(ops.launches())


def test_training_wrappers_refuse_cpu_and_bfloat16():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_kern.FlashAttentionFn.apply(q, q, q, 0)
    with pytest.raises(TypeError, match="float32 only"):
        fa_kern.FlashAttentionFn.apply(*(q.bfloat16(),) * 3, 0)
    r = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wkv_kern.WKV6SeqFn.apply(r, r, r, r, torch.zeros(2, 32),
                                 torch.zeros(1, 2, 32, 32), 64)
    assert fa_kern.LAUNCHES["flash_attention_bwd"] == 0
    assert wkv_kern.LAUNCHES["wkv6_seq_bwd"] == 0


def _extern_c_entries(src: str) -> dict:
    block = src[src.index('extern "C" {'):]
    return {name: len([p for p in params.split(",") if p.strip()])
            for name, params in re.findall(r"^int (\w+)\(([^)]*)\)", block,
                                           re.M)}


@pytest.mark.parametrize("lib", sorted(_build.SOURCES))
def test_every_library_declares_its_c_entries_with_their_arity(lib):
    entries = _extern_c_entries(_build.expanded_source(lib))
    sig = _build.SIGNATURES[lib]
    assert set(entries) == set(sig)
    for name, args in sig.items():
        assert entries[name] == len(args), name
    assert lib in _build.ERROR_STRING
