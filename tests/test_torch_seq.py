"""B7's layer call and the numerics of the tensor-core kernels, on the CPU.

* ``ref.wkv6_seq_plain`` (the function B7 computes in one launch: the
  chunked WKV6 scan, a ragged last chunk computed over its own tokens)
  against the JAX model's ``rwkv6._wkv_chunked`` (which pads the last
  chunk with w = 1 and zeros), and through ``ops.wkv6_seq``.
* A torch emulation of the 3xTF32 split the kernels use on the tensor
  cores (big = x rounded to TF32, small = x - big; a·b summed as
  small·big' + big·small' + big·big' in float32), in two roundings: the
  round-to-nearest-even of the low 13 mantissa bits, and the kernels'
  own (big rounded half away from zero by an integer add, small
  truncated to TF32 by the tensor core).  At one (b, h) of B6's serve
  shape and at the products of one rwkv6-7b chunk, the error against
  float64 stays inside the float32 gates: rtol 2e-4 / atol 2e-5 for B6,
  2e-5 of max|y| and 1e-5 of max|S| for B7.
* The model's activations pass the kernels' 16-byte alignment check
  (``aligned``) for every supported head dim in float32 and bfloat16.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as JR6
from repro_torch.configs import base as tbase
from repro_torch.kernels import flash_attention as fa_kern
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as wkv_kern
from repro_torch.models import layers as TL
from repro_torch.models import params as TPM
from repro_torch.models import rwkv6 as TR6


def close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def wkv_inputs(B, S, H, K, decay, seed):
    """r/k/v/w [B,S,H,K] (w = e^{-U(0, decay)}), u [H,K], S0 [B,H,K,K]."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, K)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-decay * rng.random((B, S, H, K))).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32)
    S0 = rng.normal(size=(B, H, K, K)).astype(np.float32)
    return r, k, v, w, u, S0


# ---------------------------------------------------------------------------
# the plain version of B7's layer call against the JAX scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(16, 8), (13, 8), (5, 8), (1, 64),
                                     (63, 64), (64, 64), (65, 64),
                                     (150, 64)])
@pytest.mark.parametrize("decay", [1.0, 3.0])
def test_wkv6_seq_plain_matches_jax_chunked_incl_the_ragged_pad(S, chunk,
                                                                decay):
    """A ragged last chunk (13 = 8 + 5, 65 = 64 + 1, 150 = 2·64 + 22) is
    computed over its own tokens; JAX pads it with w = 1 and zeros.  At
    decay 3 the ±40 clamps bite inside a 64-token chunk."""
    B, H, K = 2, 3, 16
    ins = wkv_inputs(B, S, H, K, decay, seed=S * 10 + chunk)
    y, Sf = ref.wkv6_seq_plain(*map(t, ins), chunk)
    yj, Sj = JR6._wkv_chunked(*map(jnp.asarray, ins), chunk)
    assert y.shape == (B, S, H, K) and Sf.shape == (B, H, K, K)
    close(y, yj, 2e-5)
    close(Sf, Sj, 1e-5)
    y2, S2 = ops.wkv6_seq(*map(t, ins), chunk)
    assert torch.equal(y2, y) and torch.equal(S2, Sf)


def test_wkv6_seq_plain_is_the_chunk_plain_version_chunk_by_chunk():
    """The layer call over S = 2·Q equals two one-chunk calls carrying the
    state: the cumsum and the clamps restart at each chunk."""
    B, S, H, K, Q = 1, 16, 2, 8, 8
    r, k, v, w, u, S0 = map(t, wkv_inputs(B, S, H, K, 3.0, seed=4))
    y, Sf = ref.wkv6_seq_plain(r, k, v, w, u, S0, Q)
    hm = [x.transpose(1, 2) for x in (r, k, v, w)]
    y0, S1 = ref.wkv6_chunk_plain(*(x[:, :, :Q] for x in hm), u, S0)
    y1, S2 = ref.wkv6_chunk_plain(*(x[:, :, Q:] for x in hm), u, S1)
    assert torch.equal(y, torch.cat([y0, y1], dim=2).transpose(1, 2))
    assert torch.equal(Sf, S2)


def test_wkv_chunked_is_one_ops_call(monkeypatch):
    """models/rwkv6.py hands the model's [B,S,H,K] buffers to one
    ops.wkv6_seq call per layer, as they are (no pad, no copy)."""
    calls = []
    real = ops.wkv6_seq

    def spy(r, k, v, w, u, S0, chunk):
        calls.append((r, k, v, w, chunk))
        return real(r, k, v, w, u, S0, chunk)

    monkeypatch.setattr(ops, "wkv6_seq", spy)
    r, k, v, w, u, S0 = map(t, wkv_inputs(2, 13, 3, 16, 1.0, seed=5))
    TR6._wkv_chunked(r, k, v, w, u, S0, 8)
    assert len(calls) == 1
    assert all(a is b for a, b in zip(calls[0][:4], (r, k, v, w)))
    assert calls[0][4] == 8


# ---------------------------------------------------------------------------
# the 3xTF32 split, emulated
# ---------------------------------------------------------------------------

def _bits(x):
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _float(b):
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b)
    return b.to(torch.int32).view(torch.float32)


def tf32_rne(x):
    """x rounded to TF32 (10 mantissa bits), nearest, ties to even."""
    b = _bits(x)
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    return _float(b)


def split_rne(x):
    big = tf32_rne(x)
    return big, tf32_rne(x - big)


def split_kernel(x):
    """The kernels' split (csrc/tf32_mma.cuh): big rounded half away from
    zero by adding 0x1000 to the bits; small = x - big, of which the
    tensor core reads the top 19 bits (truncation)."""
    big = _float((_bits(x) + 0x1000) & 0xFFFFE000)
    return big, _float(_bits(x - big) & 0xFFFFE000)


SPLITS = {"rne": split_rne, "kernel": split_kernel}


def mm3(a, b, split):
    """a @ b (float32) as the kernels sum it: small·big + big·small +
    big·big, every TF32 product exact in float32, sums in float32."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


@pytest.mark.parametrize("mode", sorted(SPLITS))
def test_3xtf32_attention_holds_the_float32_gate(mode):
    """One (b, h) of B6's qwen3-0.6b prefill: S = 512, D = 128, causal."""
    split = SPLITS[mode]
    rng = np.random.default_rng(11)
    S, D = 512, 128
    q, k, v = (torch.from_numpy(rng.normal(size=(S, D)).astype(np.float32))
               for _ in range(3))
    mask = ref.attention_mask(S, S, 0, "cpu")
    s = mm3(q * (1.0 / math.sqrt(D)), k.T.contiguous(), split)
    s = torch.where(mask, s, torch.full_like(s, ref.NEG_INF))
    m = s.max(dim=1, keepdim=True).values
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    got = mm3(p, v, split) / p.sum(dim=1, keepdim=True)
    qd, kd, vd = q.double(), k.double(), v.double()
    sd = (qd @ kd.T) / math.sqrt(D)
    sd = torch.where(mask, sd, torch.full_like(sd, -math.inf))
    want = torch.softmax(sd, dim=1) @ vd
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-5)
    # one plain TF32 product would not hold it: the split is needed
    one = tf32_rne(p) @ tf32_rne(v) / p.sum(dim=1, keepdim=True)
    assert np.abs(one.numpy() - want.numpy()).max() > 2e-5


def _chunk_products(r, k, v, w, u, S0, mm):
    """One chunk in the kernel's order, products by mm (r/k/v/w [Q,K])."""
    lc = ref.WKV_LOG_CLAMP
    logw = torch.log(w)
    c = torch.cumsum(logw, dim=0)
    ce = c - logw
    mid = 0.5 * c[-1:]
    r_dec = r * torch.exp(torch.clamp(ce - mid, -lc, lc))
    k_grow = k * torch.exp(torch.clamp(mid - c, -lc, lc))
    r_state = r * torch.exp(torch.clamp(ce, min=-2 * lc))
    k_end = k * torch.exp(torch.clamp(c[-1:] - c, min=-2 * lc))
    Q = r.shape[0]
    tri = torch.ones((Q, Q), dtype=torch.bool).tril(-1)
    A = mm(r_dec, k_grow.T.contiguous())
    A = torch.where(tri, A, torch.zeros_like(A))
    y = (mm(A, v) + (r * u * k).sum(-1, keepdim=True) * v) + mm(r_state, S0)
    S1 = (torch.exp(torch.clamp(c[-1], min=-2 * lc))[:, None] * S0
          + mm(k_end.T.contiguous(), v))
    return y, S1


@pytest.mark.parametrize("mode", sorted(SPLITS))
@pytest.mark.parametrize("decay", [1.0, 3.0])
def test_3xtf32_wkv_chunk_products_hold_the_float32_gates(mode, decay):
    """One (b, h) chunk of rwkv6-7b: Q = K = 64, nonzero state, w in
    (e^-decay, 1); the four products by 3xTF32 against float64."""
    split = SPLITS[mode]
    r, k, v, w, u, S0 = wkv_inputs(1, 64, 1, 64, decay, seed=12)
    r, k, v, w = (torch.from_numpy(x[0, :, 0]) for x in (r, k, v, w))
    u, S0 = torch.from_numpy(u[0]), torch.from_numpy(S0[0, 0])
    got = _chunk_products(r, k, v, w, u, S0,
                          lambda a, b: mm3(a, b, split))
    want = _chunk_products(*(x.double() for x in (r, k, v, w, u, S0)),
                           torch.matmul)
    close(got[0], want[0], 2e-5)
    close(got[1], want[1], 1e-5)


# ---------------------------------------------------------------------------
# the model's tensors meet the kernels' 16-byte row alignment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", fa_kern.SUPPORTED_D)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_attention_views_are_16_byte_aligned(D, dtype, monkeypatch):
    """gqa_attention passes [B,H,S,D] views of its [B,S,H,D] activations
    to B6: their rows start on 16 bytes for every D in both types."""
    seen = []
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, window=0: seen.append((q, k, v))
                        or ref.flash_attention_ref(q, k, v, window))
    a = tbase.AttentionSpec(n_heads=4, n_kv_heads=2, head_dim=D,
                            qk_norm=True, rope_theta=1e6)
    d = 32
    g = torch.Generator().manual_seed(D)
    p = {"wq": torch.randn(d, 4, D, generator=g),
         "wk": torch.randn(d, 2, D, generator=g),
         "wv": torch.randn(d, 2, D, generator=g),
         "wo": torch.randn(4, D, d, generator=g),
         "q_norm": torch.ones(D), "k_norm": torch.ones(D)}
    p = {n: x.to(dtype) for n, x in p.items()}
    x = torch.randn(2, 7, d, generator=g).to(dtype)
    TL.gqa_attention(p, a, x, torch.arange(7))
    assert len(seen) == 1
    for tensor in seen[0]:
        assert tensor.dtype == dtype and tensor.stride(-1) == 1
        assert fa_kern.aligned(tensor)


def test_model_wkv_buffers_are_16_byte_aligned(monkeypatch):
    """rwkv6_timemix hands B7 its r/k/v/w [B,S,H,K] buffers, aligned."""
    seen = []
    real = ops.wkv6_seq

    def spy(r, k, v, w, u, S0, chunk):
        seen.append((r, k, v, w))
        return real(r, k, v, w, u, S0, chunk)

    monkeypatch.setattr(ops, "wkv6_seq", spy)
    spec = tbase.RWKVSpec(head_dim=16, decay_lora=8, mix_lora=4, chunk=8)
    g = torch.Generator().manual_seed(3)
    p = TPM.init_params(TR6.rwkv6_defs(32, 64, spec), g)
    TR6.rwkv6_timemix(p, spec, torch.randn(2, 12, 32, generator=g))
    assert len(seen) == 1
    strides = seen[0][0].stride()
    for tensor in seen[0]:
        assert tensor.stride() == strides and wkv_kern.aligned(tensor)
