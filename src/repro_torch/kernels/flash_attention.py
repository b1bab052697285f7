"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``), B6: it replaces the Pallas kernel
``flash_attention_pallas`` of the JAX package's
``kernels/flash_attention.py``.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
that the head dimension is contiguous, allocates the output with
``torch.empty_like(q)`` (so a [B, H, S, D] view of [B, S, H, D]
activations comes back in the same layout), launches on the current
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
"""
from __future__ import annotations

import ctypes

import torch

from ._build import aligned, error_string, load

SUPPORTED_D = (64, 80, 128)     # csrc FLASH_CASE instances
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches since the last reset_launches()
LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"flash_attention: {name} must be a CUDA tensor "
                             f"(CPU tensors take the plain version through "
                             f"kernels.ops)")
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: q, k, v must share one dtype "
                            f"of {list(DTYPES)}, got {q.dtype}, {k.dtype}, "
                            f"{v.dtype}")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k, v on different cards")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dimension must "
                             f"be contiguous, strides {t.stride()}")
    B, H, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} needs k, v "
                         f"[B, Hkv, T, D], got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"Hkv={Hkv}")
    if D not in SUPPORTED_D:
        raise ValueError(f"flash_attention: head dim {D} has no kernel "
                         f"instance; supported: {SUPPORTED_D}")
    if min(S, k.shape[2]) == 0:
        raise ValueError("flash_attention: empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not aligned(t):
            raise ValueError(f"flash_attention: {name}'s rows are not "
                             f"16-byte aligned (data_ptr % 16 = "
                             f"{t.data_ptr() % 16}, strides {t.stride()}, "
                             f"{t.element_size()}-byte elements): the "
                             f"kernel copies rows in 16-byte pieces")


def flash_attention(q, k, v, window: int = 0):
    """q [B,H,S,D], k/v [B,Hkv,T,D] (float32 or bfloat16, H a multiple
    of Hkv) -> [B,H,S,D] in q's dtype: causal (and, with window > 0,
    sliding-window) softmax attention, query head h on kv head
    h // (H/Hkv), math in float32."""
    _check(q, k, v)
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lib = load("flash_attention")
    st = [x for t in (q, k, v, o) for x in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            DTYPES[q.dtype], B, H, Hkv, S, T, D, *st, int(window), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {rc} "
                           f"({error_string('flash_attention', rc)})")
    LAUNCHES["flash_attention"] += 1
    return o
