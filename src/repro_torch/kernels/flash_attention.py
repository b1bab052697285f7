"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``), B6: it replaces the Pallas kernel
``flash_attention_pallas`` of the JAX package's
``kernels/flash_attention.py``.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
that the head dimension is contiguous, allocates the output in q's
layout (so a [B, H, S, D] view of [B, S, H, D] activations comes back
in the same layout), launches on the current
stream, raises if the launch reports an error, and adds one to
:data:`LAUNCHES`.  The plain version is ``ref.flash_attention_ref``;
:mod:`.ops` picks between the two by the tensor's device.  Nothing is
padded: ragged S and T are masked inside the kernel.

The kernel loads K and V tiles with 16-byte asynchronous copies, so every
row start of q, k, v (and of the output, which takes q's strides) must be
16-byte aligned: the wrapper checks ``data_ptr()`` and the (batch, head,
sequence) strides with ``_build.aligned`` and raises otherwise; it never
copies.  The model's [B, S, H, D] activations pass for every supported D
in float32 and bfloat16.

Head widths: q and k have D columns, v and the output Dv.  The kernels
have an instance for each (D, Dv) of :data:`SUPPORTED_PAIRS`: D = Dv for
the GQA configs (:data:`SUPPORTED_D`: 96 is phi-3-vision-4.2b's), and for
MLA (96, 64) (minicpm3-4b:
q/k are qk_nope 64 + qk_rope 32, v is 64) and (192, 128) (deepseek-v2:
qk_nope 128 + qk_rope 64, v 128), scaled by 1/√D.  Any other pair
raises.

Training (:class:`FlashAttentionFn`, float32 only): the forward also
writes each row's log-sum-exp, and the backward is the hand-written
``csrc/flash_attention_bwd.cu`` (three launches: Di = rowsum(dO ∘ o), a
dK/dV kernel, a dQ kernel; no atomics).  The Function saves q, k, v, o
and the log-sum-exp and copies none of them; a dO whose head dimension
is not contiguous or whose rows are off 16 bytes is copied once, and
:data:`COPIES` counts it.  The plain gradient is autograd's of
``ref.flash_attention_ref`` (``ref.flash_attention_grads_ref``).
"""
from __future__ import annotations

import ctypes

import torch

from ._build import aligned, error_string, load

SUPPORTED_D = (64, 80, 96, 128)     # the instances with Dv = D
# (D of q and k, Dv of v and the output): csrc FLASH_CASE / BWD_CASE
SUPPORTED_PAIRS = tuple((d, d) for d in SUPPORTED_D) + ((96, 64), (192, 128))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches since the last reset_launches(): forward launches, and
# backward calls (three kernels each)
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
# dO tensors the backward had to copy to a layout its kernels read
COPIES = {"flash_attention_bwd.dO": 0}


def reset_launches() -> None:
    for c in (LAUNCHES, COPIES):
        for key in c:
            c[key] = 0


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be a 4-D tensor, "
                             f"got {getattr(t, 'shape', type(t))}")
    # the shapes and the instance first, whatever the device
    B, H, S, D = q.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B
            or k.shape[3] != D):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} needs k "
                         f"[B, Hkv, T, D] and v [B, Hkv, T, Dv], got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"Hkv={Hkv}")
    if (D, v.shape[3]) not in SUPPORTED_PAIRS:
        raise ValueError(f"flash_attention: head dims (q/k {D}, v "
                         f"{v.shape[3]}) have no kernel instance; "
                         f"supported (D, Dv): {SUPPORTED_PAIRS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} must be a CUDA tensor "
                             f"(CPU tensors take the plain version through "
                             f"kernels.ops)")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: q, k, v must share one dtype "
                            f"of {list(DTYPES)}, got {q.dtype}, {k.dtype}, "
                            f"{v.dtype}")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k, v on different cards")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dimension must "
                             f"be contiguous, strides {t.stride()}")
    if min(S, k.shape[2]) == 0:
        raise ValueError("flash_attention: empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not aligned(t):
            raise ValueError(f"flash_attention: {name}'s rows are not "
                             f"16-byte aligned (data_ptr % 16 = "
                             f"{t.data_ptr() % 16}, strides {t.stride()}, "
                             f"{t.element_size()}-byte elements): the "
                             f"kernel copies rows in 16-byte pieces")


def _like(q, width: int):
    """An empty [B, H, S, width] tensor in q's layout: ``empty_like(q)``
    where the widths agree, else its (batch, head, sequence) axes in the
    order of q's strides."""
    if width == q.shape[3]:
        return torch.empty_like(q)
    order = sorted(range(3), key=lambda i: -q.stride(i))   # outermost first
    buf = torch.empty([q.shape[i] for i in order] + [width], dtype=q.dtype,
                      device=q.device)
    return buf.permute([order.index(i) for i in range(3)] + [3])


def _forward(q, k, v, window: int, with_lse: bool):
    _check(q, k, v)
    B, H, S, D = q.shape
    Hkv, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    o = _like(q, Dv)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = load("flash_attention")
    st = [x for t in (q, k, v, o) for x in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), DTYPES[q.dtype], B, H,
            Hkv, S, T, D, Dv, *st, int(window), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {rc} "
                           f"({error_string('flash_attention', rc)})")
    LAUNCHES["flash_attention"] += 1
    return o, lse


def flash_attention(q, k, v, window: int = 0):
    """q [B,H,S,D], k [B,Hkv,T,D], v [B,Hkv,T,Dv] (float32 or
    bfloat16, H a multiple of Hkv, (D, Dv) in :data:`SUPPORTED_PAIRS`)
    -> [B,H,S,Dv] in q's dtype: causal (and, with window > 0,
    sliding-window) softmax attention scaled by 1/√D, query head h on kv
    head h // (H/Hkv), math in float32."""
    return _forward(q, k, v, window, False)[0]


def flash_attention_lse(q, k, v, window: int = 0):
    """:func:`flash_attention` that also returns each row's log-sum-exp
    of the scaled logits, [B,H,S] float32 (+inf for a row that sees no
    key): the training forward, one launch."""
    return _forward(q, k, v, window, True)


def _train_dtype(fn, *ts):
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: the backward kernel is float32 only, got "
                            f"{t.dtype} (train in float32; bfloat16 runs "
                            f"the forward alone)")


def flash_attention_bwd(q, k, v, o, lse, dO, window: int = 0):
    """The gradients (dq, dk, dv) of :func:`flash_attention` at (q, k,
    v) given its output o, its log-sum-exp and dO [B,H,S,Dv], float32:
    three launches (Di, dK/dV, dQ), outputs in q's, k's and v's
    layouts."""
    _check(q, k, v)
    _train_dtype("flash_attention_bwd", q, dO)
    B, H, S, D = q.shape
    Hkv, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    if dO.shape != (B, H, S, Dv) or o.shape != (B, H, S, Dv):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and dO "
                         f"{tuple(dO.shape)} must be [{B}, {H}, {S}, {Dv}]")
    if (tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be contiguous "
                         f"float32 [{B}, {H}, {S}], got {tuple(lse.shape)}")
    if dO.stride(-1) != 1 or not aligned(dO):
        dO = dO.contiguous()
        COPIES["flash_attention_bwd.dO"] += 1
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    di = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    for name, t in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        if t.stride(-1) != 1 or not aligned(t):
            raise ValueError(f"flash_attention_bwd: {name}'s rows are not "
                             f"16-byte aligned or its head dimension is not "
                             f"contiguous (strides {t.stride()})")
    lib = load("flash_attention_bwd")
    st = [x for t in (q, k, v, o, dO, dq, dk, dv) for x in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dO.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, Hkv, S, T, D, Dv, *st,
            int(window), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd: kernel launch failed with "
                           f"CUDA error {rc} "
                           f"({error_string('flash_attention_bwd', rc)})")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """B6 with its hand-written backward: the forward is one launch that
    also writes the log-sum-exp; q, k, v, o and the log-sum-exp are
    saved as they are (no copy)."""

    @staticmethod
    def forward(ctx, q, k, v, window: int = 0):
        _train_dtype("FlashAttentionFn", q, k, v)
        o, lse = flash_attention_lse(q, k, v, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = int(window)
        return o

    @staticmethod
    def backward(ctx, dO):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, dO, ctx.window)
        return dq, dk, dv, None
