"""Wrapper of the hand-written CUDA WKV6 chunk kernel
(``csrc/wkv6.cu``), B7: it replaces the Pallas kernel
``wkv6_chunk_pallas`` of the JAX package's ``kernels/wkv6.py``.

The wrapper takes CUDA float32 tensors only: it checks device, dtype,
shapes and layout, allocates y and S_out with ``torch.empty``, launches
on the current stream, raises if the launch reports an error, and adds
one to :data:`LAUNCHES`.  r/k/v/w may be strided views (one chunk of a
[B, H, S, K] buffer) as long as they share their strides and the
channel is contiguous.  The plain version is ``ref.wkv6_chunk_plain``;
:mod:`.ops` picks between the two by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import error_string, load

SUPPORTED_K = (32, 64)          # csrc instances
MAX_Q = 64                      # shared-memory sizing of the kernel

# launches since the last reset_launches()
LAUNCHES = {"wkv6_chunk": 0}


def reset_launches() -> None:
    LAUNCHES["wkv6_chunk"] = 0


def _check(r, k, v, w, u, S_in):
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("S_in", S_in)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"wkv6_chunk: {name} must be a CUDA tensor "
                             f"(CPU tensors take the plain version through "
                             f"kernels.ops)")
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6_chunk: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != r.device:
            raise ValueError("wkv6_chunk: inputs on different cards")
    if r.ndim != 4:
        raise ValueError(f"wkv6_chunk: r must be [B, H, Q, K], got "
                         f"{tuple(r.shape)}")
    B, H, Q, K = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape or t.stride() != r.stride():
            raise ValueError(f"wkv6_chunk: {name} must have r's shape and "
                             f"strides, got {tuple(t.shape)} {t.stride()} vs "
                             f"{tuple(r.shape)} {r.stride()}")
    if r.stride(-1) != 1:
        raise ValueError(f"wkv6_chunk: the channel must be contiguous, "
                         f"strides {r.stride()}")
    if K not in SUPPORTED_K or not 1 <= Q <= MAX_Q:
        raise ValueError(f"wkv6_chunk: Q={Q}, K={K} has no kernel instance; "
                         f"Q in 1..{MAX_Q}, K in {SUPPORTED_K}")
    if tuple(u.shape) != (H, K) or not u.is_contiguous():
        raise ValueError(f"wkv6_chunk: u must be contiguous [{H}, {K}], got "
                         f"{tuple(u.shape)}")
    if tuple(S_in.shape) != (B, H, K, K) or not S_in.is_contiguous():
        raise ValueError(f"wkv6_chunk: S_in must be contiguous "
                         f"[{B}, {H}, {K}, {K}], got {tuple(S_in.shape)}")
    return B, H, Q, K


def wkv6_chunk(r, k, v, w, u, S_in):
    """One RWKV-6 chunk: r/k/v/w [B,H,Q,K], u [H,K], S_in [B,H,K,K]
    (float32) -> (y [B,H,Q,K], S_out [B,H,K,K])."""
    B, H, Q, K = _check(r, k, v, w, u, S_in)
    y = torch.empty((B, H, Q, K), dtype=torch.float32, device=r.device)
    S_out = torch.empty_like(S_in)
    lib = load("wkv6")
    with torch.cuda.device(r.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.wkv6_chunk_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), S_in.data_ptr(), y.data_ptr(), S_out.data_ptr(),
            B, H, Q, K, *r.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_chunk: kernel launch failed with CUDA "
                           f"error {rc} ({error_string('wkv6', rc)})")
    LAUNCHES["wkv6_chunk"] += 1
    return y, S_out
