"""The prefix-embedding path of the port (the stub vision / audio
frontends) and its two configs, musicgen-large and phi-3-vision-4.2b,
against the JAX package on the same numpy inputs:

* the configs field by field, full and reduced, ``InputShape`` and the
  assigned shapes (``configs/shapes.py``);
* ``LMWorkerPipeline``'s tokens and prefix arrays bit-equal to the JAX
  pipeline's;
* at ``reduced()`` (2 layers, 8 prefix embeddings, float32, JAX weights
  perturbed by seeded noise): the forward logits over prefix + tokens,
  the loss (the logits from position P on) and every gradient leaf
  (``jax.value_and_grad``), the fused prefill with the prefix and 4
  teacher-forced decode steps from position P + S over a float32 and a
  bfloat16 cache, ``serve.generate`` with a prefix, one train step;
* B6's plain version and its gradient at phi-3-vision's head dim, the
  (96, 96) pair, against float64, and the wrapper's instance list.

Tolerances (``test_torch_zoo.py``'s): logits within 1e-4 of the largest
|logit| and cache leaves within 1e-4 of their largest magnitude over a
float32 cache; over a bfloat16 cache the logits within 1e-3 and the
cache leaves within 2^-7; the loss within 1e-5 relative and each
gradient leaf within 1e-4 of its largest |g|; the plain attention
within 1e-5 of float64.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import base as jbase
from repro.configs import get_config as j_get_config
from repro.data import pipeline as JPL
from repro.models import params as JPM
from repro.models import transformer as JTF
from repro_torch.configs import SHAPES, get_config, get_shape
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as PL
from repro_torch.kernels import flash_attention as fa_kern
from repro_torch.kernels import ref
from repro_torch.launch import serve, train
from repro_torch.models import params as TPM
from repro_torch.models import transformer as TTF

ARCHS = ("musicgen-large", "phi-3-vision-4.2b")
PARAMS = {"musicgen-large": 3_229_812_736, "phi-3-vision-4.2b": 3_821_079_552}
TOL = 1e-4
BF16_TOL = 1e-3
BF16_CACHE_TOL = 2.0 ** -7
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


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


# ---------------------------------------------------------------------------
# the configs, the shapes and the pipeline
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
    assert get_config(arch).reduced().n_prefix_tokens == 8
    assert TPM.count_params(TTF.param_defs(get_config(arch))) == \
        JPM.count_params(JTF.param_defs(j_get_config(arch))) == PARAMS[arch]


def test_input_shapes_are_the_jax_shapes():
    assert [f.name for f in dataclasses.fields(tbase.InputShape)] == \
        [f.name for f in dataclasses.fields(jbase.InputShape)]
    assert sorted(SHAPES) == sorted(J_SHAPES)
    for name, s in J_SHAPES.items():
        assert dataclasses.asdict(get_shape(name)) == dataclasses.asdict(s)


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_prefix_is_the_jax_pipelines_bit_for_bit(arch):
    """[m, b, P, d] float32 from default_rng(step), under a label-flip
    attack (which corrupts tokens, not the prefix), at two steps."""
    jc, tc = j_get_config(arch).reduced(), get_config(arch).reduced()
    jbyz = jbase.ByzantineConfig(attack="label_flip", alpha=0.25)
    tbyz = tbase.ByzantineConfig(attack="label_flip", alpha=0.25)
    jp = JPL.LMWorkerPipeline(jc, 4, 2, 16, seed=3, byz=jbyz)
    tp = PL.LMWorkerPipeline(tc, 4, 2, 16, seed=3, byz=tbyz)
    for step in (0, 5):
        want, got = jp.batch(step), tp.batch(step)
        assert sorted(got) == sorted(want) == ["prefix_embed", "tokens"]
        assert got["prefix_embed"].shape == (4, 2, 8, tc.d_model)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert "prefix_embed" not in PL.LMWorkerPipeline(
        get_config("qwen3-0.6b").reduced(), 2, 1, 8).batch(0)


# ---------------------------------------------------------------------------
# the model at reduced() with its prefix
# ---------------------------------------------------------------------------

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
def test_loss_and_gradient_match_jax(arch):
    """A [2, 24] batch of the pipeline with its 8 prefix embeddings:
    the loss (the logits from position 8 on predict tokens 1..) and
    every leaf's gradient.  (The forward logits are held in the prefill
    test, against the reference's prefill.)"""
    jcfg, tcfg, jp, tp = _setup(arch)
    b = PL.LMWorkerPipeline(tcfg, 1, 2, 24, seed=1).batch(2)
    toks, pfx = b["tokens"][0], b["prefix_embed"][0]
    jbatch = {"tokens": jnp.asarray(toks), "prefix_embed": jnp.asarray(pfx)}
    tbatch = {"tokens": torch.from_numpy(toks),
              "prefix_embed": torch.from_numpy(pfx)}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JTF.loss_fn(jcfg, p, jbatch), has_aux=True))(jp)
    got, _ = TTF.forward(tcfg, tp, tbatch["tokens"], tbatch["prefix_embed"])
    assert got.shape == (2, 8 + 24, tcfg.vocab)
    leaves = _flat(tp)
    for x in leaves.values():
        x.requires_grad_(True)
    loss, _ = TTF.loss_fn(tcfg, tp, tbatch)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    for x in leaves.values():
        x.requires_grad_(False)
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    # the prefix is context only: the loss reads logits[:, 8:-1]
    lp = torch.log_softmax(got[:, 8:-1].double(), -1)
    ce = -torch.gather(lp, -1, tbatch["tokens"][:, 1:, None].long()).mean()
    assert abs(float(ce) - loss) <= LOSS_TOL * loss
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
    """Fused prefill of 8 prefix embeddings and 11 tokens (the logits,
    and the port's forward's, and every cache leaf: K/V at positions
    0..18), then 4 decode steps from position 19 fed JAX's greedy
    tokens."""
    jcfg, tcfg, jp, tp = _setup(arch, seed=2)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol, cache_tol = ((TOL, TOL) if dtype == "float32"
                      else (BF16_TOL, BF16_CACHE_TOL))
    B, S, T, steps = 2, 11, 24, 4
    P = tcfg.n_prefix_tokens
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab, (B, S))
    pfx = PL.prefix_embeddings(tcfg, 7, (B,))
    jl, jc = jax.jit(JTF.prefill_cache, static_argnums=0)(
        jcfg, jp, jnp.asarray(tokens, jnp.int32),
        JTF.init_cache(jcfg, B, T, jdt), jnp.asarray(pfx))
    decode = jax.jit(JTF.decode_step, static_argnums=0)
    tl, tc = TTF.prefill_cache(tcfg, tp, torch.from_numpy(tokens),
                               TTF.init_cache(tcfg, B, T, tdt),
                               torch.from_numpy(pfx))
    assert tl.shape == (B, P + S, tcfg.vocab)
    close(tl, jl)
    close(TTF.forward(tcfg, tp, torch.from_numpy(tokens),
                      torch.from_numpy(pfx))[0], jl)

    def leaves_close(got, want):
        assert sorted(_flat(got)) == sorted(_flat(want))
        for k, g in _flat(got).items():
            assert g.dtype == tdt, k
            close(g, np.asarray(_flat(want)[k], np.float32), cache_tol)
    leaves_close(tc, jc)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    for i in range(steps):
        jl, jc = decode(jcfg, jp, jc, jnp.asarray(tok, jnp.int32),
                        jnp.int32(P + S + i))
        tl, tc = TTF.decode_step(tcfg, tp, tc, torch.tensor(tok), P + S + i)
        close(tl, jl, tol)
        tok = np.asarray(jnp.argmax(jl.reshape(B, -1), axis=-1))[:, None]
    leaves_close(tc, jc)


def test_generate_with_a_prefix_decodes_after_it():
    """serve.generate's prefix: prefill over P + S positions, greedy
    decode from P + S; its tokens and last logits are the teacher-forced
    chain's (itself held to JAX above)."""
    _, tcfg, _, tp = _setup("musicgen-large", seed=4)
    B, S, gen = 2, 9, 3
    P = tcfg.n_prefix_tokens
    prompt = torch.randint(0, tcfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(0))
    pfx = torch.from_numpy(PL.prefix_embeddings(tcfg, 1, (B,)))
    toks, logits, *_ = serve.generate(tcfg, tp, prompt, gen, P + S + gen,
                                      prefix_embed=pfx)
    cache = TTF.init_cache(tcfg, B, P + S + gen, torch.float32)
    lg, cache = TTF.prefill_cache(tcfg, tp, prompt, cache, pfx)
    tok = lg[:, -1].argmax(-1)[:, None]
    want = []
    for i in range(gen):
        want.append(tok[:, 0])
        lg, cache = TTF.decode_step(tcfg, tp, cache, tok, P + S + i)
        tok = lg.reshape(B, -1).argmax(-1)[:, None]
    assert torch.equal(toks, torch.stack(want, 1))
    assert torch.equal(logits, lg)


def test_prefix_is_cast_to_the_embeddings_dtype():
    _, tcfg, _, tp = _setup("phi-3-vision-4.2b", seed=5)
    pfx = torch.randn(1, 8, tcfg.d_model).to(torch.bfloat16)
    x = TTF.embed_inputs(tcfg, tp, torch.zeros(1, 3, dtype=torch.long), pfx)
    assert x.dtype == torch.float32 and x.shape == (1, 11, tcfg.d_model)
    assert torch.equal(x[:, :8], pfx.float())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_steps_with_the_prefix(arch):
    """launch.train.main at reduced() on the CPU, 4 workers under
    sign_flip, sgd: the pipeline's prefix reaches every worker's loss,
    the steps finite."""
    hist = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--workers", "4", "--steps", "2",
                       "--batch-per-worker", "1", "--seq", "16",
                       "--attack", "sign_flip", "--alpha", "0.25",
                       "--optimizer", "sgd"])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["gnorm"])
               for h in hist)


# ---------------------------------------------------------------------------
# B6 at phi-3-vision's head dim
# ---------------------------------------------------------------------------

def _attention64(q, k, v, window):
    """float64 einsum of causal (window) GQA attention, scale 1/sqrt(D)."""
    G = q.shape[1] // k.shape[1]
    kx, vx = (x.repeat_interleave(G, dim=1) for x in (k, v))
    s = torch.einsum("bhsd,bhtd->bhst", q, kx) / np.sqrt(q.shape[3])
    mask = ref.attention_mask(q.shape[2], k.shape[2], window, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, -1), vx)


@pytest.mark.parametrize("window", [0, 9])
def test_plain_attention_and_gradient_at_96(window):
    B, H, Hkv, S, D = 2, 4, 2, 37, 96
    rng = np.random.default_rng(window)
    q, k, v, dO = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   for s in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                             (B, H, S, D)))
    got = ref.flash_attention_ref(q, k, v, window)
    close(got, _attention64(q.double(), k.double(), v.double(), window)
          .numpy(), 1e-5)
    grads = ref.flash_attention_grads_ref(q, k, v, dO, window)
    leaves = [x.double().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(_attention64(*leaves, window), leaves,
                               dO.double())
    for g, w, x in zip(grads, want, (q, k, v)):
        assert g.shape == x.shape
        close(g, w.numpy(), 1e-5)


def test_phi3_vision_head_dim_has_an_instance():
    a = get_config("phi-3-vision-4.2b").attention
    assert (a.head_dim, a.head_dim) == (96, 96)
    assert 96 in fa_kern.SUPPORTED_D and (96, 96) in fa_kern.SUPPORTED_PAIRS
    q = torch.zeros(1, 2, 8, 96)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_kern.flash_attention(q, q, q)
