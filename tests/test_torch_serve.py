"""The port's serve path as a whole against the JAX package, for
qwen3-0.6b-smoke and rwkv6-7b-smoke (2 layers, d = 256, vocab 512,
float32): the full-sequence forward, the fused prefill with every cache
leaf, teacher-forced greedy decode steps, the port's own prefill ==
sequential decode property, and the serve entry point.

The JAX parameters (perturbed by seeded noise so that the zero- and
one-initialised leaves — bonus u, the mixes, the decay base, the norms —
take part) carry across leaf by leaf.  Tolerances: logits within 1e-4
of the largest |logit| (B6/B7's plain versions sum in another order
than the JAX model's _sdpa and scan), cache leaves within 1e-4 of their
largest magnitude, greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import params as JPM
from repro.models import transformer as JTF
from repro_torch.configs import get_config
from repro_torch.configs.base import AttentionSpec, ModelConfig, SSMSpec
from repro_torch.launch import serve
from repro_torch.models import params as TPM
from repro_torch.models import transformer as TTF

ARCHS = ("qwen3-0.6b", "rwkv6-7b")
TOL = 1e-4


def close(got, want, rtol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
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


def _leaves_close(got: dict, want: dict, path=""):
    assert sorted(got) == sorted(want), path
    for k in got:
        if isinstance(got[k], dict):
            _leaves_close(got[k], want[k], f"{path}/{k}")
        else:
            assert got[k].dtype == torch.float32, f"{path}/{k}"
            close(got[k], want[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab, (2, 19))
    want, _ = JTF.forward(jcfg, jp, jnp.asarray(tokens, jnp.int32))
    got, _ = TTF.forward(tcfg, tp, torch.from_numpy(tokens))
    close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_teacher_forced_decode_match_jax(arch):
    """Fused prefill (logits and every cache leaf), then 4 decode steps
    fed JAX's greedy tokens: logits at every step, the caches after the
    last, and the port's greedy tokens equal JAX's."""
    jcfg, tcfg, jp, tp = _setup(arch, seed=2)
    B, S, T, steps = 2, 11, 16, 4
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab, (B, S))
    jl, jc = JTF.prefill_cache(jcfg, jp, jnp.asarray(tokens, jnp.int32),
                               JTF.init_cache(jcfg, B, T, jnp.float32))
    tl, tc = TTF.prefill_cache(tcfg, tp, torch.from_numpy(tokens),
                               TTF.init_cache(tcfg, B, T, torch.float32))
    close(tl, jl)
    _leaves_close(tc, jc)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    for i in range(steps):
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), tok[:, 0])
        jl, jc = JTF.decode_step(jcfg, jp, jc, jnp.asarray(tok, jnp.int32),
                                 jnp.int32(S + i))
        tl, tc = TTF.decode_step(tcfg, tp, tc, torch.tensor(tok), S + i)
        close(tl, jl)
        tok = np.asarray(jnp.argmax(jl.reshape(B, -1), axis=-1))[:, None]
    assert np.array_equal(tl.reshape(B, -1).argmax(-1).numpy(), tok[:, 0])
    _leaves_close(tc, jc)


def _sequential(cfg, params, tokens, T):
    cache = TTF.init_cache(cfg, tokens.shape[0], T, torch.float32)
    logits = []
    for s in range(tokens.shape[1]):
        lg, cache = TTF.decode_step(cfg, params, cache, tokens[:, s:s + 1], s)
        logits.append(lg[:, 0])
    return torch.stack(logits, dim=1), cache


@pytest.mark.parametrize("arch,window", [("qwen3-0.6b", 0),
                                         ("qwen3-0.6b", 4),
                                         ("rwkv6-7b", 0)])
def test_prefill_equals_sequential_decode(arch, window):
    """The port's own property (tests/test_serving.py pins it for JAX):
    one prefill == S decode steps, logits and cache; with a window the
    cache is a 4-slot ring buffer the prefill fills as decode would."""
    cfg = get_config(arch).reduced()
    if window:
        cfg = dataclasses.replace(
            cfg, attention=dataclasses.replace(cfg.attention, window=window))
    params = TPM.init_params(TTF.param_defs(cfg),
                             torch.Generator().manual_seed(5))
    B, S, T = 2, 8, 12
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(6))
    lf, cf = TTF.prefill_cache(cfg, params, tokens,
                               TTF.init_cache(cfg, B, T, torch.float32))
    ls, cs = _sequential(cfg, params, tokens, T)
    close(lf, ls)
    _leaves_close(cf, {k: {kk: vv.numpy() for kk, vv in v.items()}
                       for k, v in cs.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "9", "--gen", "3",
                      "--repeat", "2"])
    assert out["logits_finite"] and out["tokens"].shape == (2, 3)
    assert out["n_layers"] == 2 and out["repeat"] == 2
    # the CPU path launches no kernel, in either phase
    for phase in ("prefill", "decode"):
        assert set(out["launches"][phase].values()) == {0}
    text = capsys.readouterr().out
    assert "prefill:" in text and "decode :" in text


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "qwen3-0.6b", "--reduced"])


def test_unported_segments_raise():
    """The hybrid segment is ported; a hybrid config whose n_layers is
    not a multiple of hybrid_attn_every raises, as the reference
    asserts."""
    att = AttentionSpec(n_heads=4, n_kv_heads=2, head_dim=16)
    hyb = ModelConfig("h", "hybrid", 5, 64, 128, 64, att,
                      ssm=SSMSpec(state_dim=8, head_dim=8),
                      hybrid_attn_every=2)
    with pytest.raises(ValueError, match="not a multiple"):
        TTF.param_defs(hyb)
    defs = TTF.param_defs(dataclasses.replace(hyb, n_layers=4))
    assert defs["seg_0"]["m"]["w_x"].shape == (2, 2, 64, 128)
