"""RWKV6 "Finch" block (the port of the JAX package's
``models/rwkv6.py``): attention-free time-mix with data-dependent decay
(WKV6) and the squared-ReLU channel-mix.

Time-mix state per head: S ∈ R^{K×K}; per token
    y_t   = r_t · (S_t + diag(u)·k_t v_tᵀ)
    S_t+1 = diag(w_t)·S_t + k_t v_tᵀ
with w_t = exp(-exp(base + lora(x'_t))) data-dependent per channel.

A prompt (S > 1 with ``chunk`` > 0) runs the chunked-parallel form, one
``ops.wkv6_seq`` call per layer (kernel B7 on the card, all chunks in one
launch);
the single-token decode step and configs with chunk = 0 run the
per-token recurrence ``_wkv_scan`` in plain torch on both devices, as
the JAX package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import RWKVSpec
from ..kernels import ops
from .layers import activate, rms_norm
from .params import ParamDef

_MIX = 5  # r,k,v,w,g


def rwkv6_defs(d_model: int, d_ff: int, r: RWKVSpec) -> dict:
    H = d_model // r.head_dim
    K = r.head_dim
    return {
        # time-mix
        "mu": ParamDef((_MIX, d_model), (None, "embed"), init="zeros"),
        "mix_A": ParamDef((d_model, _MIX * r.mix_lora), ("embed", None), scale=0.1),
        "mix_B": ParamDef((_MIX, r.mix_lora, d_model), (None, None, "embed"), scale=0.1),
        "w_r": ParamDef((d_model, d_model), ("embed", "heads")),
        "w_k": ParamDef((d_model, d_model), ("embed", "heads")),
        "w_v": ParamDef((d_model, d_model), ("embed", "heads")),
        "w_g": ParamDef((d_model, d_model), ("embed", "heads")),
        "decay_base": ParamDef((d_model,), (None,), init="zeros"),
        "decay_A": ParamDef((d_model, r.decay_lora), ("embed", None), scale=0.1),
        "decay_B": ParamDef((r.decay_lora, d_model), (None, "embed"), scale=0.1),
        "bonus_u": ParamDef((H, K), (None, None), init="zeros"),
        "ln_gamma": ParamDef((d_model,), (None,), init="ones"),
        "w_o": ParamDef((d_model, d_model), ("heads", "embed")),
        # channel-mix
        "cm_mu": ParamDef((2, d_model), (None, "embed"), init="zeros"),
        "w_ck": ParamDef((d_model, d_ff), ("embed", "ff")),
        "w_cv": ParamDef((d_ff, d_model), ("ff", "embed")),
        "w_cr": ParamDef((d_model, d_model), ("embed", "embed")),
    }


def _shift(x, last=None):
    """x_{t-1} along seq.  last: [B,1,D] carry for decode (it may be a
    bfloat16 cache entry: JAX's concatenate promotes, so it is cast to
    x's type here)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(x, xprev, mu, mix_A, mix_B):
    """Data-dependent lerp producing the 5 mixed inputs [5,B,S,D]."""
    diff = xprev - x
    xx = x + diff * 0.5                       # coarse mix for the lora input
    lora = torch.tanh(xx @ mix_A)                            # [B,S,5*rank]
    lora = lora.reshape(*lora.shape[:2], _MIX, -1)           # [B,S,5,rank]
    dyn = torch.einsum("bsmr,mrd->mbsd", lora, mix_B)        # [5,B,S,D]
    mix = mu[:, None, None, :] + dyn                         # [5,B,S,D]
    return x[None] + diff[None] * mix


def _wkv_scan(r, k, v, w, u, S0):
    """Per-token recurrence.  r,k,v,w: [B,S,H,K] (w the decay in (0,1)),
    u: [H,K], S0 [B,H,K,K].  Returns y [B,S,H,K], final state."""
    S = S0
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]     # [B,H,K]
        kv = kt[..., :, None] * vt[..., None, :]             # [B,H,K,K]
        ys.append(torch.einsum("bhk,bhkj->bhj", rt,
                               S + u[None, :, :, None] * kv))
        S = wt[..., None] * S + kv
    return torch.stack(ys, dim=1), S


def _wkv_chunked(r, k, v, w, u, S0, chunk: int):
    """Chunked-parallel WKV6: the prompt in chunks of Q = min(chunk, S)
    tokens (the last one ragged, equal to the JAX pad of w = 1 and zeros),
    the [B,H,K,K] state carried from chunk to chunk.  r,k,v,w [B,S,H,K]
    -> (y [B,S,H,K], final state): one ``ops.wkv6_seq`` call, which is
    one B7 launch on the card over the model's buffers as they are."""
    return ops.wkv6_seq(r, k, v, w, u, S0, chunk)


def rwkv6_timemix(p, r: RWKVSpec, x, last_x=None, state=None):
    B, S, D = x.shape
    H, K = D // r.head_dim, r.head_dim
    xprev = _shift(x, last_x)
    mixed = _ddlerp(x.float(), xprev.float(), p["mu"].float(), p["mix_A"],
                    p["mix_B"])
    xr, xk, xv, xw, xg = [m.to(x.dtype) for m in mixed]
    rr = (xr @ p["w_r"]).reshape(B, S, H, K).float()
    kk = (xk @ p["w_k"]).reshape(B, S, H, K).float()
    vv = (xv @ p["w_v"]).reshape(B, S, H, K).float()
    g = F.silu(xg @ p["w_g"])
    dec = (p["decay_base"].float()
           + torch.tanh(xw @ p["decay_A"]) @ p["decay_B"])
    w = torch.exp(-torch.exp(dec.float())).reshape(B, S, H, K)
    if state is None:
        state = torch.zeros((B, H, K, K), dtype=torch.float32,
                            device=x.device)
    u = p["bonus_u"].float().contiguous()
    if r.chunk and S > 1:
        y, state = _wkv_chunked(rr, kk, vv, w, u, state.contiguous(),
                                r.chunk)
    else:
        y, state = _wkv_scan(rr, kk, vv, w, u, state)
    y = y.reshape(B, S, D)
    # the default eps (1e-5), as in the reference, not cfg.rms_eps
    y = rms_norm(y, p["ln_gamma"]).to(x.dtype) * g
    return y @ p["w_o"], (x[:, -1:], state)


def rwkv6_channelmix(p, x, last_x=None):
    xprev = _shift(x, last_x)
    diff = xprev - x
    xk = x + diff * p["cm_mu"][0]
    xr = x + diff * p["cm_mu"][1]
    k = activate(xk @ p["w_ck"], "relu2")
    out = torch.sigmoid(xr @ p["w_cr"]) * (k @ p["w_cv"])
    return out, x[:, -1:]
