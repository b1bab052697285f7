"""The port's model zoo pieces against the JAX package on the same numpy
inputs: the config copies, the parameter trees, the plain versions of
kernels B6 (flash attention) and B7 (the WKV6 chunk) against the Pallas
kernels in interpret mode and their oracles, and the layers and rwkv6
blocks at reduced sizes.

Tolerances: B6 rtol 2e-4 / atol 2e-5 in float32 and 5e-2 in bfloat16
(the JAX package's own kernel test); B7 within 2e-5 of max|y| and 1e-5
of max|S| (the factorised form sums in another order); layers and
blocks within 1e-5 of the largest reference magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import base as jbase
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import flash_attention_ref as j_flash_ref
from repro.kernels.wkv6 import wkv6_chunk_pallas, wkv6_chunk_ref as j_wkv_ref
from repro.models import layers as JL
from repro.models import params as JPM
from repro.models import rwkv6 as JR6
from repro.models import transformer as JTF
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import base as tbase
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL
from repro_torch.models import params as TPM
from repro_torch.models import rwkv6 as TR6
from repro_torch.models import transformer as TTF

RTOL = 1e-5


def close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

SPECS = ("AttentionSpec", "MoESpec", "SSMSpec", "RWKVSpec", "ModelConfig")


@pytest.mark.parametrize("name", SPECS)
def test_spec_classes_have_the_jax_fields(name):
    jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jbase, name))
          if f.default is not dataclasses.MISSING]
    tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tbase, name))
          if f.default is not dataclasses.MISSING]
    assert [f.name for f in dataclasses.fields(getattr(tbase, name))] == \
        [f.name for f in dataclasses.fields(getattr(jbase, name))]
    assert tf == jf


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_config_copies_equal_the_jax_configs(arch):
    """The port's copies of qwen3-0.6b and rwkv6-7b must not drift from
    src/repro/configs, full and reduced, field by field."""
    for reduce in (False, True):
        jc, tc = j_get_config(arch), get_config(arch)
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.is_moe == jc.is_moe


def test_unported_archs_name_their_slice():
    """Every arch of the JAX package's registry resolves in the port (no
    slice is left to name); any other name is an unknown arch."""
    from repro.configs import ARCHS as J_ARCHS
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for name in J_ARCHS:
        assert get_config(name).name == name
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_trees_carry_across_leaf_by_leaf(arch):
    cfg = get_config(arch).reduced()
    jdefs = JTF.param_defs(j_get_config(arch).reduced())
    tdefs = TTF.param_defs(cfg)
    assert TPM.count_params(tdefs) == JPM.count_params(jdefs)
    jp = JPM.init_params(jdefs, jax.random.PRNGKey(0))
    tp = TPM.params_from_jax(jp)
    got = TPM.tree_map_defs(lambda d: d.shape, tdefs)
    want = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert got == want
    flat = TPM.tree_leaves(tp)
    assert len(flat) == len(jax.tree.leaves(jp))
    for a, b in zip(flat, jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the port's own init: same shapes, fan-in scaled (stack axes excluded)
    mine = TPM.init_params(tdefs, torch.Generator().manual_seed(0))
    assert _shapes(mine) == got
    seg = mine["seg_0"]
    attn = seg.get("attn", {})
    if "m" in seg:                                # hybrid: [U, sub, in, out]
        w = seg["m"]["w_x"]
        fan_in = w.shape[2]
    else:
        w = attn.get("wq", attn.get("w_uq")) if attn else seg["tm"]["w_r"]
        fan_in = int(np.prod(w.shape[1:-1]))      # [L, in..., out]
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(tree[k]) for k in sorted(tree)}
    return tuple(tree.shape)


# ---------------------------------------------------------------------------
# B6: flash attention's plain version
# ---------------------------------------------------------------------------

FLASH_SHAPES = [(1, 2, 2, 64, 16, 0),      # MHA causal
                (2, 4, 2, 128, 32, 0),     # GQA
                (1, 2, 1, 100, 16, 0),     # ragged S
                (1, 2, 2, 256, 16, 64),    # sliding window
                (1, 1, 1, 48, 8, 16)]      # small + window


@pytest.mark.parametrize("B,H,Hkv,S,D,win", FLASH_SHAPES)
def test_flash_attention_plain_matches_pallas_and_oracle(B, H, Hkv, S, D,
                                                         win):
    rng = np.random.default_rng(S + D)
    q, k, v = (normal(rng, B, h, S, D) for h in (H, Hkv, Hkv))
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              window=win, qb=32, kb=32))
    got = ops.flash_attention(t(q), t(k), t(v), win)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    oracle = np.asarray(j_flash_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), window=win))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-4, atol=2e-5)


def test_flash_attention_plain_bf16():
    rng = np.random.default_rng(1)
    q, k, v = (jnp.asarray(normal(rng, 1, 2, 64, 16)).astype(jnp.bfloat16)
               for _ in range(3))
    want = np.asarray(j_flash(q, k, v, qb=16, kb=16), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
                  for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("S,win", [(9, 0), (12, 4), (7, 16)])
def test_attention_mask_is_the_models_causal_window_mask(S, win):
    got = ref.attention_mask(S, S, win, "cpu").numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(JL._causal_window_mask(S, S,
                                                                    win)))


# ---------------------------------------------------------------------------
# B7: the WKV6 chunk's plain version
# ---------------------------------------------------------------------------

def _wkv_inputs(B, H, Q, K, wlo, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (normal(rng, B, H, Q, K) for _ in range(3))
    w = rng.uniform(wlo, 0.999, size=(B, H, Q, K)).astype(np.float32)
    return r, k, v, w, normal(rng, H, K), normal(rng, B, H, K, K)


@pytest.mark.parametrize("B,H,Q,K,wlo", [(2, 3, 8, 8, 0.1),
                                         (1, 2, 32, 16, 0.3),
                                         (2, 1, 64, 64, 0.5),
                                         (1, 1, 16, 32, 0.05)])
def test_wkv6_chunk_plain_matches_pallas_and_the_recurrence(B, H, Q, K, wlo):
    ins = _wkv_inputs(B, H, Q, K, wlo, B * 100 + Q)
    yj, Sj = wkv6_chunk_pallas(*map(jnp.asarray, ins))
    y, S = ops.wkv6_chunk(*map(t, ins))
    close(y, yj, 2e-5)
    close(S, Sj, 1e-5)
    # the sequential oracles (port and JAX) agree with each other, and
    # the factorised form with them at the JAX kernel test's tolerance
    ys, Ss = ref.wkv6_chunk_ref(*map(t, ins))
    yo, So = j_wkv_ref(*map(jnp.asarray, ins))
    close(ys, yo, 2e-5)
    close(Ss, So, 1e-5)
    scale = max(1.0, float(np.abs(np.asarray(yo)).max()))
    np.testing.assert_allclose(y.numpy() / scale, np.asarray(yo) / scale,
                               atol=2e-5)
    np.testing.assert_allclose(S.numpy(), np.asarray(So), rtol=1e-3,
                               atol=1e-3)


def test_wkv6_chunk_plain_where_the_clamps_bite():
    """log w uniform in (-3, 0) over Q = 64: a chunk's decay spans ~96
    nats, past the 80 that the ±40 clamps of the centred factors allow.
    The plain version must still be the JAX body (``rwkv6._wkv_chunked``
    over one chunk), not the recurrence."""
    B, H, Q, K = 2, 2, 64, 32
    r, k, v, _, u, S0 = _wkv_inputs(B, H, Q, K, 0.5, 7)
    rng = np.random.default_rng(8)
    w = np.exp(-rng.uniform(0.0, 3.0, size=(B, H, Q, K))).astype(np.float32)
    c_end = np.log(w).sum(axis=2)
    assert (c_end < -2 * 40).mean() > 0.5     # the clamps bite in most
    y, S = ops.wkv6_chunk(t(r), t(k), t(v), t(w), t(u), t(S0))
    sw = lambda x: jnp.asarray(x).swapaxes(1, 2)          # noqa: E731
    yj, Sj = JR6._wkv_chunked(sw(r), sw(k), sw(v), sw(w), jnp.asarray(u),
                              jnp.asarray(S0), Q)
    close(y.transpose(1, 2), yj, 2e-5)
    close(S, Sj, 1e-5)
    assert np.isfinite(y.numpy()).all() and np.isfinite(S.numpy()).all()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _att_spec(window=0, qk_norm=True):
    return (jbase.AttentionSpec(n_heads=4, n_kv_heads=2, head_dim=16,
                                qk_norm=qk_norm, rope_theta=1e6,
                                window=window),
            tbase.AttentionSpec(n_heads=4, n_kv_heads=2, head_dim=16,
                                qk_norm=qk_norm, rope_theta=1e6,
                                window=window))


def _gqa_params(rng, d, a):
    p = {"wq": normal(rng, d, a.n_heads, a.head_dim) / np.sqrt(d),
         "wk": normal(rng, d, a.n_kv_heads, a.head_dim) / np.sqrt(d),
         "wv": normal(rng, d, a.n_kv_heads, a.head_dim) / np.sqrt(d),
         "wo": normal(rng, a.n_heads, a.head_dim, d) / 8.0}
    if a.qk_norm:
        p["q_norm"] = 1.0 + 0.1 * normal(rng, a.head_dim)
        p["k_norm"] = 1.0 + 0.1 * normal(rng, a.head_dim)
    return p


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: t(v) for k, v in p.items()})


def test_rms_norm_mlp_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x, g = normal(rng, 2, 5, 3, 16), 1.0 + normal(rng, 16)
    close(TL.rms_norm(t(x), t(g), 1e-6), JL.rms_norm(x, g, 1e-6))
    pos = np.array([[0, 3, 7, 11, 40]])
    close(TL.apply_rope(t(x), torch.from_numpy(pos), 1e6),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    # the halves are rotated, not interleaved pairs: position 1 moves
    # x[..., 0] against x[..., D/2]
    e = np.zeros((1, 1, 1, 16), np.float32)
    e[..., 0] = 1.0
    out = TL.apply_rope(t(e), torch.tensor([[1]]), 1e6).numpy()
    assert abs(out[..., 8].item() - np.sin(1.0)) < 1e-6
    h = normal(rng, 2, 5, 32)
    for gated, act in ((True, "silu"), (False, "relu2"), (True, "gelu")):
        p = {"w_in": normal(rng, 32, 48), "w_out": normal(rng, 48, 32)}
        if gated:
            p["w_gate"] = normal(rng, 32, 48)
        jp, tp = _both(p)
        close(TL.mlp(tp, t(h), act), JL.mlp(jp, jnp.asarray(h), act))


@pytest.mark.parametrize("S", [128, 4096])
def test_rope_angles_on_the_cpu_are_float64_rounded_once(S):
    """The rotation's cos and sin on the CPU are those of float64,
    rounded once to float32 (no float32 CPU cos on the path), at every
    angle up to the sequence length; the rotation stays within float32
    rounding of a float64 one."""
    pos = torch.arange(S)[None]
    inv = TL.rope_freqs(64, 1e6)
    ang = pos[..., None].float() * inv
    cos, sin = TL._cos_sin(ang)
    assert cos.dtype == sin.dtype == torch.float32
    assert torch.equal(cos, torch.cos(ang.double()).float())
    assert torch.equal(sin, torch.sin(ang.double()).float())
    x = normal(np.random.default_rng(1), 1, S, 2, 64)
    got = TL.apply_rope(t(x), pos, 1e6).numpy()
    a = ang.double().numpy()[..., None, :]
    x1, x2 = np.split(x.astype(np.float64), 2, axis=-1)
    want = np.concatenate([x1 * np.cos(a) - x2 * np.sin(a),
                           x1 * np.sin(a) + x2 * np.cos(a)], axis=-1)
    close(got, want, rtol=1e-6)


@pytest.mark.parametrize("window", [0, 4])
def test_gqa_attention_matches_jax(window):
    rng = np.random.default_rng(window)
    ja, ta = _att_spec(window)
    jp, tp = _both(_gqa_params(rng, 32, ja))
    x = normal(rng, 2, 11, 32)
    pos = np.arange(11)
    out, (k, v) = TL.gqa_attention(tp, ta, t(x), torch.from_numpy(pos))
    jout, (jk, jv) = JL.gqa_attention(jp, ja, jnp.asarray(x),
                                      jnp.asarray(pos))
    close(out, jout)
    close(k, jk)
    close(v, jv)


@pytest.mark.parametrize("window,pos", [(0, 5), (0, (3, 7)), (4, 6),
                                        (4, (2, 9))])
def test_gqa_decode_matches_jax(window, pos):
    """Scalar and per-slot positions; the cache holds random (stale)
    entries beyond each slot's position, which take part in the row max
    of _sdpa but not in its sum."""
    rng = np.random.default_rng(11)
    ja, ta = _att_spec(window)
    jp, tp = _both(_gqa_params(rng, 32, ja))
    B, T = 2, (4 if window else 12)
    x = normal(rng, B, 1, 32)
    ck, cv = 3.0 * normal(rng, B, T, 2, 16), normal(rng, B, T, 2, 16)
    out, (k2, v2) = TL.gqa_decode(tp, ta, t(x), t(ck), t(cv),
                                  torch.tensor(pos))
    jout, (jk, jv) = JL.gqa_decode(jp, ja, jnp.asarray(x), jnp.asarray(ck),
                                   jnp.asarray(cv), jnp.asarray(pos))
    close(out, jout)
    close(k2, jk)
    close(v2, jv)


def test_sdpa_row_max_ignores_the_mask():
    """A masked slot with a huge logit still sets the row max: the valid
    weights underflow and the output is 0/max(0, 1e-30) = 0 in both
    packages, where a masked max would give v[0]."""
    q = np.ones((1, 1, 1, 4), np.float32)
    k = np.stack([np.ones(4), 1e3 * np.ones(4)])[None, :, None, :]
    v = np.ones((1, 2, 1, 4), np.float32)
    mask = np.array([True, False])[None, None, None, None, :]
    got = TL._sdpa(t(q), t(k), t(v), torch.from_numpy(mask))
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k, jnp.float32),
                    jnp.asarray(v), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.abs().max()) == 0.0


def test_sdpa_with_a_bf16_cache_matches_jax():
    """float32 q against a bfloat16 cache: JAX promotes, the port casts;
    the weights are rounded to bfloat16 and so is the output."""
    rng = np.random.default_rng(3)
    q = normal(rng, 2, 1, 4, 16)
    kc = jnp.asarray(normal(rng, 2, 9, 2, 16)).astype(jnp.bfloat16)
    vc = jnp.asarray(normal(rng, 2, 9, 2, 16)).astype(jnp.bfloat16)
    mask = (np.arange(9)[None, :] <= np.array([[4], [8]]))[:, None, None,
                                                           None, :]
    want = JL._sdpa(jnp.asarray(q), kc, vc, jnp.asarray(mask))
    tk, tv = (torch.from_numpy(np.asarray(c, np.float32)).bfloat16()
              for c in (kc, vc))
    got = TL._sdpa(t(q), tk, tv, torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


# ---------------------------------------------------------------------------
# rwkv6
# ---------------------------------------------------------------------------

def _rwkv_params(rng, D, d_ff, r):
    jdefs = JR6.rwkv6_defs(D, d_ff, r)
    out = {}
    for name, d in jdefs.items():
        base = {"zeros": 0.0, "ones": 1.0}.get(d.init, 0.0)
        fan = d.shape[0] if len(d.shape) == 1 else int(np.prod(d.shape[:-1]))
        noise = normal(rng, *d.shape)
        out[name] = (base + d.scale * noise / np.sqrt(fan)
                     if d.init == "normal" else base + 0.3 * noise)
    return out


RW = jbase.RWKVSpec(head_dim=16, decay_lora=8, mix_lora=4, chunk=8)
TRW = tbase.RWKVSpec(head_dim=16, decay_lora=8, mix_lora=4, chunk=8)


def test_ddlerp_and_shift_match_jax():
    rng = np.random.default_rng(5)
    p = _rwkv_params(rng, 32, 64, RW)
    x, last = normal(rng, 2, 6, 32), normal(rng, 2, 1, 32)
    close(TR6._shift(t(x), t(last)), JR6._shift(jnp.asarray(x),
                                                jnp.asarray(last)))
    xp = np.asarray(JR6._shift(jnp.asarray(x)))
    close(TR6._ddlerp(t(x), t(xp), t(p["mu"]), t(p["mix_A"]), t(p["mix_B"])),
          JR6._ddlerp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(p["mu"]),
                      jnp.asarray(p["mix_A"]), jnp.asarray(p["mix_B"])))


@pytest.mark.parametrize("S,chunk", [(16, 8), (13, 8), (5, 8)])
def test_wkv_chunked_matches_jax_incl_the_ragged_pad(S, chunk):
    """S = 13 takes the w = 1 pad to 16; S = 5 < chunk runs Q = S."""
    rng = np.random.default_rng(S)
    B, H, K = 2, 3, 16
    r, k, v = (normal(rng, B, S, H, K) for _ in range(3))
    w = rng.uniform(0.2, 0.99, size=(B, S, H, K)).astype(np.float32)
    u, S0 = normal(rng, H, K), normal(rng, B, H, K, K)
    y, Sf = TR6._wkv_chunked(t(r), t(k), t(v), t(w), t(u), t(S0), chunk)
    yj, Sj = JR6._wkv_chunked(*map(jnp.asarray, (r, k, v, w, u, S0)), chunk)
    close(y, yj)
    close(Sf, Sj)
    ys, Ss = TR6._wkv_scan(t(r), t(k), t(v), t(w), t(u), t(S0))
    ysj, Ssj = JR6._wkv_scan(*map(jnp.asarray, (r, k, v, w, u, S0)))
    close(ys, ysj)
    close(Ss, Ssj)
    close(y, ysj, 1e-4)                   # chunked == recurrence


@pytest.mark.parametrize("S,with_state", [(12, False), (1, True)])
def test_rwkv6_timemix_and_channelmix_match_jax(S, with_state):
    rng = np.random.default_rng(21 + S)
    p = _rwkv_params(rng, 32, 64, RW)
    jp, tp = _both(p)
    x = normal(rng, 2, S, 32)
    last = normal(rng, 2, 1, 32) if with_state else None
    st = normal(rng, 2, 2, 16, 16) if with_state else None
    opt = lambda a, f: None if a is None else f(a)          # noqa: E731
    y, (tx, Sf) = TR6.rwkv6_timemix(tp, TRW, t(x), opt(last, t), opt(st, t))
    yj, (txj, Sj) = JR6.rwkv6_timemix(jp, RW, jnp.asarray(x),
                                      opt(last, jnp.asarray),
                                      opt(st, jnp.asarray))
    close(y, yj)
    close(tx, txj)
    close(Sf, Sj)
    c, cx = TR6.rwkv6_channelmix(tp, t(x), opt(last, t))
    cj, cxj = JR6.rwkv6_channelmix(jp, jnp.asarray(x), opt(last, jnp.asarray))
    close(c, cj)
    close(cx, cxj)
