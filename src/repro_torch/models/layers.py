"""Shared transformer layers (the port of the JAX package's
``models/layers.py``): RMSNorm, RoPE, activations, the dense MLP, GQA
attention and MLA (the low-rank latent attention of MiniCPM3 /
DeepSeek-V2), each in its full-sequence and single-token decode form.

Parameters are dicts in the JAX layouts ([in, out] dense, ``wq``
[d, H, D], ``wo`` [H, D, d]).  The full-sequence attention goes through
``ops.flash_attention`` (kernel B6 on the card; MLA's q/k and v widths
differ, (96, 64) at minicpm3-4b, an instance of its own); the decode
attention stays plain torch on both devices, as the JAX package
computes it outside any Pallas kernel (its mask is per slot, which B6
has not; MLA decodes in the weight-absorbed form over the latent
cache).

Dtypes follow the JAX promotion rules of the reference: where JAX mixes
a float32 operand with a bfloat16 cache and promotes, the port casts to
the promoted type explicitly (``torch.einsum`` does not promote).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import AttentionSpec
from ..kernels import ops
from .params import ParamDef


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps=1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


def activate(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":           # jax.nn.gelu defaults to the tanh form
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":          # squared ReLU (nemotron / rwkv channel-mix)
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")


def rope_freqs(head_dim: int, theta: float, device=None):
    ex = torch.arange(0, head_dim, 2, dtype=torch.float32,
                      device=device) / head_dim
    return 1.0 / (theta ** ex)


def _cos_sin(ang):
    """(cos, sin) of the float32 angles; on the CPU in float64, rounded
    once to float32, so no float32 CPU cos is on the path: in some
    processes torch's float32 CPU cos returned values 1.5e-4 off (at
    angles up to the sequence length) where it is otherwise within
    4e-8.  The card keeps float32."""
    if ang.is_cuda:
        return torch.cos(ang), torch.sin(ang)
    a = ang.to(torch.float64)
    return torch.cos(a).to(ang.dtype), torch.sin(a).to(ang.dtype)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D] (D even), positions: [..., S].  Rotates the two
    halves of the head dimension (not interleaved pairs)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                     # [D/2]
    ang = positions[..., None].float() * inv                 # [..., S, D/2]
    cos, sin = _cos_sin(ang)
    cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _promote(a, b):
    """a cast to the type JAX would promote a (op) b to."""
    return a.to(torch.promote_types(a.dtype, b.dtype))


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def mlp_defs(d_model: int, d_ff: int, gated: bool) -> dict:
    d = {
        "w_in": ParamDef((d_model, d_ff), ("embed", "ff")),
        "w_out": ParamDef((d_ff, d_model), ("ff", "embed")),
    }
    if gated:
        d["w_gate"] = ParamDef((d_model, d_ff), ("embed", "ff"))
    return d


def mlp(p, x, activation: str):
    h = x @ p["w_in"]
    if "w_gate" in p:
        h = activate(x @ p["w_gate"], activation) * h
    else:
        h = activate(h, activation)
    return h @ p["w_out"]


# ---------------------------------------------------------------------------
# attention (GQA, optional qk-norm / sliding window)
# ---------------------------------------------------------------------------

def gqa_defs(d_model: int, a: AttentionSpec) -> dict:
    d = {
        "wq": ParamDef((d_model, a.n_heads, a.head_dim), ("embed", "heads", "hd")),
        "wk": ParamDef((d_model, a.n_kv_heads, a.head_dim), ("embed", "kv", "hd")),
        "wv": ParamDef((d_model, a.n_kv_heads, a.head_dim), ("embed", "kv", "hd")),
        "wo": ParamDef((a.n_heads, a.head_dim, d_model), ("heads", "hd", "embed")),
    }
    if a.qk_norm:
        d["q_norm"] = ParamDef((a.head_dim,), (None,), init="ones")
        d["k_norm"] = ParamDef((a.head_dim,), (None,), init="ones")
    return d


def _sdpa(q, k, v, mask):
    """q [B,S,H,D], k/v [B,T,Hkv,D] with H a multiple of Hkv; mask
    broadcasts to [B,Hkv,G,S,T].  The decode attention.

    As in the reference: the row max is taken WITHOUT the mask (stale
    cache slots take part in it), the weights are cast to v's dtype
    before P·V (accumulated in float32), the 1/Σ normaliser (guarded at
    1e-30) is folded into the output, and the output is in v's dtype.
    """
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    q = q.reshape(B, S, Hkv, G, D)
    logits = torch.einsum("bshgd,bthd->bhgst", q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(D))
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = torch.sum(p, dim=-1)                                 # [B,Hkv,G,S]
    out = torch.einsum("bhgst,bthd->bshgd", p.to(v.dtype).float(), v.float())
    out = out / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, S, H, D).to(v.dtype)


def _qkv(p, a: AttentionSpec, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if a.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def gqa_attention(p, a: AttentionSpec, x, positions):
    """Full-sequence causal (sliding-window when ``a.window``) attention.
    x: [B,S,d]; positions: [S] or [B,S].  Returns (out [B,S,d], (k, v))
    with the roped k and v [B,S,Hkv,D] for the decode cache.  The mask
    (the reference's ``_causal_window_mask``) is applied inside B6 and
    its plain version ``ref.flash_attention_ref``."""
    q, k, v = _qkv(p, a, x)
    if positions.ndim == 1:
        positions = positions[None, :]
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)
    # [B,S,H,D] -> [B,H,S,D] views: the kernel reads them through strides
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), a.window).transpose(1, 2)
    out = torch.einsum("bshk,hkd->bsd", _promote(out, p["wo"]), p["wo"])
    return out, (k, v)


def _decode_pos(pos, B: int, device=None):
    """Broadcast a scalar or per-slot ``[B]`` position vector to [B]."""
    pos = torch.as_tensor(pos, dtype=torch.long, device=device)
    return pos.reshape(-1).expand(B)


def gqa_decode(p, a: AttentionSpec, x, cache_k, cache_v, pos):
    """Single-token decode.  x: [B,1,d]; cache_k/v: [B,T,Hkv,D] rolling
    (window) or absolute buffer; ``pos``: scalar absolute position of
    the new token, or a per-slot ``[B]`` vector.

    Writes the new K/V into the cache IN PLACE (the JAX package returns
    new buffers; the port saves the copy) and returns (out, (cache_k,
    cache_v)).  With a sliding window the cache is a ring buffer indexed
    pos % T.
    """
    B = x.shape[0]
    T = cache_k.shape[1]
    q, k, v = _qkv(p, a, x)
    posb = _decode_pos(pos, B, x.device)
    posv = posb[:, None]                                     # [B,1]
    q = apply_rope(q, posv, a.rope_theta)
    k = apply_rope(k, posv, a.rope_theta)
    slot = posb % T if a.window else posb                    # [B]
    rows = torch.arange(B, device=x.device)
    cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
    idx = torch.arange(T, device=x.device)
    if a.window:
        # slot j holds absolute position: the most recent write <= pos
        age = (slot[:, None] - idx[None, :]) % T
        valid = age < torch.clamp(posb + 1, max=T)[:, None]
    else:
        valid = idx[None, :] <= posb[:, None]
    mask = valid[:, None, None, None, :]                     # [B,1,1,1,T]
    out = _sdpa(q, cache_k, cache_v, mask)
    out = torch.einsum("bshk,hkd->bsd", _promote(out, p["wo"]), p["wo"])
    return out, (cache_k, cache_v)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 / MiniCPM3): low-rank latent KV, decoupled RoPE key
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def mla_defs(d_model: int, a: AttentionSpec) -> dict:
    qk_head = a.qk_nope_dim + a.qk_rope_dim
    d: dict = {}
    if a.q_lora_rank:
        d["w_dq"] = ParamDef((d_model, a.q_lora_rank), ("embed", "qlora"))
        d["q_norm"] = ParamDef((a.q_lora_rank,), (None,), init="ones")
        d["w_uq"] = ParamDef((a.q_lora_rank, a.n_heads, qk_head),
                             ("qlora", "heads", "hd"))
    else:
        d["w_uq"] = ParamDef((d_model, a.n_heads, qk_head),
                             ("embed", "heads", "hd"))
    d["w_dkv"] = ParamDef((d_model, a.kv_lora_rank), ("embed", "kvlora"))
    d["kv_norm"] = ParamDef((a.kv_lora_rank,), (None,), init="ones")
    d["w_krope"] = ParamDef((d_model, a.qk_rope_dim), ("embed", None))
    d["w_uk"] = ParamDef((a.kv_lora_rank, a.n_heads, a.qk_nope_dim),
                         ("kvlora", "heads", "hd"))
    d["w_uv"] = ParamDef((a.kv_lora_rank, a.n_heads, a.v_head_dim),
                         ("kvlora", "heads", "hd"))
    d["wo"] = ParamDef((a.n_heads, a.v_head_dim, d_model),
                       ("heads", "hd", "embed"))
    return d


def _mla_scale(a: AttentionSpec) -> float:
    """1/sqrt(qk_nope + qk_rope) rounded as the reference's float32
    ``1.0 / jnp.sqrt(...)``."""
    return float(np.float32(1.0)
                 / np.sqrt(np.float32(a.qk_nope_dim + a.qk_rope_dim)))


def _mla_q(p, a: AttentionSpec, x, positions):
    if a.q_lora_rank:
        cq = rms_norm(x @ p["w_dq"], p["q_norm"])
        q = torch.einsum("bsr,rhk->bshk", cq, p["w_uq"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["w_uq"])
    q_nope, q_rope = q[..., :a.qk_nope_dim], q[..., a.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, a.rope_theta)
    return q_nope, q_rope


def mla_attention(p, a: AttentionSpec, x, positions):
    """Full-sequence MLA.  x: [B,S,d]; positions: [S] or [B,S].  Returns
    (out [B,S,d], (c_kv [B,S,R], k_rope [B,S,Dr])), the latent cache
    pieces.

    The reference's logits q_nope·k_nope + q_rope·k_rope are one
    product over the concatenated head: q = [q_nope | rope(q_rope)] and
    k = [k_nope | k_rope broadcast over the heads], [B,S,H,Dqk], with v
    [B,S,H,Dv], through ``ops.flash_attention`` (B6's (96, 64) instance
    at minicpm3-4b), scaled by 1/sqrt(Dqk) under the causal (window)
    mask, the masked logits at -1e30 before the softmax as in the
    reference."""
    B, S, _ = x.shape
    H = a.n_heads
    if positions.ndim == 1:
        positions = positions[None, :]
    q_nope, q_rope = _mla_q(p, a, x, positions)
    c_kv = rms_norm(x @ p["w_dkv"], p["kv_norm"])           # [B,S,R]
    k_rope = apply_rope((x @ p["w_krope"])[:, :, None, :], positions,
                        a.rope_theta)                        # [B,S,1,Dr]
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uv"]).contiguous()
    q = torch.cat([q_nope, q_rope], dim=-1)                  # [B,S,H,Dqk]
    k = torch.cat([k_nope, k_rope.expand(B, S, H, a.qk_rope_dim)], dim=-1)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), a.window).transpose(1, 2)
    out = torch.einsum("bshk,hkd->bsd", _promote(out, p["wo"]), p["wo"])
    return out, (c_kv, k_rope.squeeze(2))


def mla_decode(p, a: AttentionSpec, x, cache_c, cache_kr, pos):
    """Weight-absorbed single-token MLA decode.  x: [B,1,d]; cache_c:
    [B,T,R] latent; cache_kr: [B,T,Dr] rope key; ``pos``: scalar or
    per-slot ``[B]`` absolute positions (see :func:`gqa_decode`).

    score_h(t) = (W_uk,hᵀ q_nope,h) · c_t + q_rope,h · k_rope,t and
    out_h = (Σ_t w_t c_t) W_uv,h, plain torch as the reference computes
    it, with its roundings: the softmax weights are cast to the cache's
    dtype and the context Σ_t w_t c_t is rounded to it (bfloat16 over a
    bfloat16 cache).  Writes the new entries into the cache IN PLACE
    and returns (out, (cache_c, cache_kr))."""
    B = x.shape[0]
    posb = _decode_pos(pos, B, x.device)
    posv = posb[:, None]                                     # [B,1]
    q_nope, q_rope = _mla_q(p, a, x, posv)                   # [B,1,H,*]
    c_new = rms_norm(x @ p["w_dkv"], p["kv_norm"])           # [B,1,R]
    kr_new = apply_rope((x @ p["w_krope"])[:, :, None, :], posv,
                        a.rope_theta).squeeze(2)             # [B,1,Dr]
    rows = torch.arange(B, device=x.device)
    cache_c[rows, posb] = c_new[:, 0].to(cache_c.dtype)
    cache_kr[rows, posb] = kr_new[:, 0].to(cache_kr.dtype)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])  # [B,1,H,R]
    logits = (torch.einsum("bshr,btr->bhst", q_abs.float(), cache_c.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             cache_kr.float()))
    logits = logits * _mla_scale(a)
    T = cache_c.shape[1]
    valid = torch.arange(T, device=x.device)[None, :] <= posb[:, None]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1).to(cache_c.dtype)
    ctx = torch.einsum("bhst,btr->bshr", w.float(),
                       cache_c.float()).to(cache_c.dtype)    # [B,1,H,R]
    out = torch.einsum("bshr,rhk->bshk", _promote(ctx, p["w_uv"]),
                       p["w_uv"])
    out = torch.einsum("bshk,hkd->bsd", _promote(out, p["wo"]), p["wo"])
    return out, (cache_c, cache_kr)
