"""Mamba2 (SSD) block (the port of the JAX package's ``models/mamba2.py``):
the chunked state-space dual form — a quadratic form within each chunk
and a recurrence carried across the chunks — with a single group of
B / C, a scalar decay A per head, a depthwise causal convolution over
the (x, B, C) projection and a gated RMSNorm on the output.

Decode keeps O(1) state: the convolution's last ``conv_width - 1``
inputs and the SSM state [B, H, N, P].

The JAX package has no Pallas kernel here: the projections and the
SSD's contractions are plain ``jnp``, and so they are plain torch in
the port, float32 with TF32 off on the card.  The SSD runs in float32
whatever the activations' dtype.  Where the reference contracts three
operands in one ``einsum``, the port forms the products batched over
(batch, chunk, head) explicitly, so no [B, C, Q, Q, H, P] temporary
exists (at zamba2-2.7b's prefill it would be tens of GB); the
inter-chunk ``lax.scan`` is a Python loop over the chunks.

One divergence, kept on purpose: the within-chunk decay
L[i, j] = exp(cum_i - cum_j) is formed with the entries above the
diagonal set to -inf BEFORE the exponent (``_intra_decay``), where the
reference takes ``exp`` of the whole Q x Q block and masks after it.
The values are the same (exp(-inf) = 0, the kept entries untouched),
but above the diagonal cum_i - cum_j is a sum of up to Q positive terms
dt·|A|, and at a 256-token chunk exp of it overflows to inf: the
reference's gradient through its masked exp is then 0 · inf = NaN
(ROADMAP §C.5), the port's is finite.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import SSMSpec
from .layers import rms_norm
from .params import ParamDef


def dims(d_model: int, s: SSMSpec):
    d_inner = s.expand * d_model
    n_heads = s.n_heads or d_inner // s.head_dim
    return d_inner, n_heads


def mamba2_defs(d_model: int, s: SSMSpec) -> dict:
    di, H = dims(d_model, s)
    N, W = s.state_dim, s.conv_width
    return {
        "w_z": ParamDef((d_model, di), ("embed", "inner")),
        "w_x": ParamDef((d_model, di), ("embed", "inner")),
        "w_B": ParamDef((d_model, N), ("embed", "state")),
        "w_C": ParamDef((d_model, N), ("embed", "state")),
        "w_dt": ParamDef((d_model, H), ("embed", "heads")),
        "conv_k": ParamDef((W, di + 2 * N), ("conv", None), init="normal",
                           scale=0.5),
        "conv_b": ParamDef((di + 2 * N,), (None,), init="zeros"),
        "dt_bias": ParamDef((H,), (None,), init="zeros"),
        "A_log": ParamDef((H,), (None,), init="zeros"),
        "D_skip": ParamDef((H,), (None,), init="ones"),
        "gamma": ParamDef((di,), (None,), init="ones"),
        "w_out": ParamDef((di, d_model), ("inner", "embed")),
    }


def _causal_conv(xbc, kern, bias, state=None):
    """Depthwise causal conv.  xbc: [B,S,C]; kern: [W,C].

    state: [B,W-1,C] previous inputs (decode) or None (zeros).  The
    concatenation takes the promoted dtype of the two, as the
    reference's does.  Returns (out [B,S,C], new_state [B,W-1,C])."""
    W = kern.shape[0]
    if state is None:
        state = torch.zeros((xbc.shape[0], W - 1, xbc.shape[-1]),
                            dtype=xbc.dtype, device=xbc.device)
    dt = torch.promote_types(state.dtype, xbc.dtype)
    ext = torch.cat([state.to(dt), xbc.to(dt)], dim=1)        # [B,S+W-1,C]
    S = xbc.shape[1]
    out = 0
    for i in range(W):
        out = out + ext[:, i:i + S] * kern[i]
    return out + bias, ext[:, -(W - 1):]


def _intra_decay(cum):
    """L [B,C,H,Q,Q]: exp(cum_i - cum_j) for j <= i, 0 above the
    diagonal, from cum [B,C,H,Q].  The exponent is masked to -inf
    before ``exp`` (see the module note): the same values as
    ``where(mask, exp(li), 0)``, and a finite gradient."""
    Q = cum.shape[-1]
    li = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=cum.device).tril()
    return li.masked_fill(~mask, float("-inf")).exp()


def _ssd_chunked(xh, dt, A, Bc, Cc, chunk: int):
    """Chunked SSD scan.

    xh [B,S,H,P], dt [B,S,H], A [H] (negative), Bc/Cc [B,S,N].  S is
    padded with zeros up to a multiple of Q = min(chunk, S) (dt = 0
    leaves the state unchanged over the padded steps) and the output cut
    back to S.  Returns y [B,S,H,P] and the final state [B,H,N,P], both
    float32."""
    Bsz, S, H, Pd = xh.shape
    N = Bc.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
    T = xh.shape[1]
    C = T // Q
    f32 = torch.float32
    # (batch, chunk, head) leading, the chunk's positions next
    xh = xh.reshape(Bsz, C, Q, H, Pd).to(f32).permute(0, 1, 3, 2, 4)
    dt = dt.reshape(Bsz, C, Q, H).to(f32).permute(0, 1, 3, 2)  # [B,C,H,Q]
    Bc = Bc.reshape(Bsz, C, 1, Q, N).to(f32)
    Cc = Cc.reshape(Bsz, C, 1, Q, N).to(f32)
    dA = dt * A.to(f32)[:, None]                             # (<= 0)
    cum = torch.cumsum(dA, dim=-1)                           # within-chunk
    dtx = xh * dt[..., None]                                 # [B,C,H,Q,P]
    # intra-chunk: y_i = Σ_j (C_i·B_j) L[i,j] dtx_j
    G = torch.matmul(Cc, Bc.transpose(-1, -2))               # [B,C,1,Q,Q]
    y = torch.matmul(G * _intra_decay(cum), dtx)             # [B,C,H,Q,P]
    # chunk-local end states: S_c = Σ_j exp(cum_last - cum_j) B_j dtx_jᵀ
    dec_to_end = torch.exp(cum[..., -1:] - cum)              # [B,C,H,Q]
    S_loc = torch.matmul(Bc.transpose(-1, -2),
                         dec_to_end[..., None] * dtx)        # [B,C,H,N,P]
    chunk_decay = torch.exp(cum[..., -1])                    # [B,C,H]
    # the recurrence over chunks: the state entering each chunk
    S_run = torch.zeros((Bsz, H, N, Pd), dtype=f32, device=xh.device)
    prevs = []
    for c in range(C):
        prevs.append(S_run)
        S_run = S_run * chunk_decay[:, c, :, None, None] + S_loc[:, c]
    S_prev = torch.stack(prevs, dim=1)                       # [B,C,H,N,P]
    # inter-chunk: y_i += exp(cum_i) C_i · S_prev
    y = y + torch.exp(cum)[..., None] * torch.matmul(Cc, S_prev)
    y = y.permute(0, 1, 3, 2, 4).reshape(Bsz, T, H, Pd)[:, :S]
    return y, S_run


def _project(p, s: SSMSpec, x, conv_state):
    di, H = dims(x.shape[-1], s)
    N = s.state_dim
    z = x @ p["w_z"]
    xbc = torch.cat([x @ p["w_x"], x @ p["w_B"], x @ p["w_C"]], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_k"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xc, Bc, Cc = torch.split(xbc, [di, N, N], dim=-1)
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    return z, xc, Bc, Cc, dt, A, conv_state


def _gated_out(p, x, z, y):
    """y (float32, [B,S,di]) cast to x's dtype, gated RMSNorm, out
    projection."""
    y = rms_norm(y.to(x.dtype) * F.silu(z), p["gamma"])
    return y @ p["w_out"]


def mamba2_forward(p, s: SSMSpec, x, conv_state=None):
    """Full-sequence forward from zero SSM state.  x: [B,S,D];
    ``conv_state`` the convolution's previous inputs (None: zeros).
    Returns (out, (conv_state, ssm_state)): the convolution's last inputs
    [B,W-1,di+2N] and the final SSM state [B,H,N,P] float32."""
    di, H = dims(x.shape[-1], s)
    Pd = di // H
    z, xc, Bc, Cc, dt, A, conv_state = _project(p, s, x, conv_state)
    xh = xc.reshape(*xc.shape[:2], H, Pd)
    y, ssm_state = _ssd_chunked(xh, dt, A, Bc, Cc, s.chunk)
    y = y + p["D_skip"].float()[:, None] * xh.float()
    return _gated_out(p, x, z, y.reshape(*xc.shape[:2], di)), \
        (conv_state, ssm_state)


def mamba2_decode(p, s: SSMSpec, x, conv_state, ssm_state):
    """Single-token decode.  x: [B,1,D]; conv_state [B,W-1,di+2N];
    ssm_state [B,H,N,P] float32.  Returns (out [B,1,D], (conv_state,
    ssm_state)), the new states as new tensors: the conv state in the
    promoted dtype of the given one and x's, the SSM state float32."""
    di, H = dims(x.shape[-1], s)
    Pd = di // H
    z, xc, Bc, Cc, dt, A, conv_state = _project(p, s, x, conv_state)
    xh = xc.reshape(-1, H, Pd).float()                       # [B,H,P]
    dt1 = dt[:, 0]                                           # [B,H]
    dA = torch.exp(dt1 * A)                                  # [B,H]
    dBx = (Bc[:, 0].float()[:, None, :, None]
           * (dt1[:, :, None] * xh)[:, :, None, :])          # [B,H,N,P]
    ssm_state = ssm_state * dA[:, :, None, None] + dBx
    y = torch.matmul(Cc[:, 0].float()[:, None, None, :],
                     ssm_state)[:, :, 0]                     # [B,H,P]
    y = y + p["D_skip"].float()[:, None] * xh
    return _gated_out(p, x, z, y.reshape(-1, 1, di)), (conv_state, ssm_state)
