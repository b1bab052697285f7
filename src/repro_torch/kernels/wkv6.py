"""Wrapper of the hand-written CUDA WKV6 kernel (``csrc/wkv6.cu``), B7:
it replaces the Pallas kernel ``wkv6_chunk_pallas`` of the JAX package's
``kernels/wkv6.py``, and runs the whole chunked scan of
``rwkv6._wkv_chunked`` in one launch with the state kept on chip.

:func:`wkv6_seq` is the layer's call: r/k/v/w [B, S, H, K] in the
model's layout, chunks of Q = min(chunk, S) tokens, the last one ragged.
:func:`wkv6_chunk` is the one-chunk call of the same kernel on
[B, H, Q, K] inputs (the Pallas kernel's interface).

The wrappers take CUDA float32 tensors only: they check device, dtype,
shapes and layout, allocate y and the final state with ``torch.empty``,
launch on the current stream, raise if the launch reports an error, and
add one to :data:`LAUNCHES`.  r/k/v/w may be strided views as long as
they share their strides, the channel is contiguous and every row start
is 16-byte aligned (the kernel copies rows in 16-byte pieces; see
``_build.aligned``).  The plain versions are ``ref.wkv6_seq_plain`` and
``ref.wkv6_chunk_plain``; :mod:`.ops` picks by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import aligned, error_string, load

SUPPORTED_K = (32, 64)          # csrc instances
MAX_Q = 64                      # shared-memory sizing of the kernel

# launches since the last reset_launches()
LAUNCHES = {"wkv6_seq": 0}


def reset_launches() -> None:
    LAUNCHES["wkv6_seq"] = 0


def _check(fn, r, k, v, w, u, S_in, layout):
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("S_in", S_in)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{fn}: {name} must be a CUDA tensor (CPU "
                             f"tensors take the plain version through "
                             f"kernels.ops)")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"{fn}: inputs on different cards")
    if r.ndim != 4:
        raise ValueError(f"{fn}: r must be {layout}, got {tuple(r.shape)}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape or t.stride() != r.stride():
            raise ValueError(f"{fn}: {name} must have r's shape and "
                             f"strides, got {tuple(t.shape)} {t.stride()} vs "
                             f"{tuple(r.shape)} {r.stride()}")
    if r.stride(-1) != 1:
        raise ValueError(f"{fn}: the channel must be contiguous, strides "
                         f"{r.stride()}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if not aligned(t):
            raise ValueError(f"{fn}: {name}'s rows are not 16-byte aligned "
                             f"(data_ptr % 16 = {t.data_ptr() % 16}, strides "
                             f"{t.stride()}): the kernel copies rows in "
                             f"16-byte pieces")


def _check_state(fn, u, S_in, B, H, K):
    if tuple(u.shape) != (H, K) or not u.is_contiguous():
        raise ValueError(f"{fn}: u must be contiguous [{H}, {K}], got "
                         f"{tuple(u.shape)}")
    if tuple(S_in.shape) != (B, H, K, K) or not S_in.is_contiguous():
        raise ValueError(f"{fn}: S_in must be contiguous "
                         f"[{B}, {H}, {K}, {K}], got {tuple(S_in.shape)}")


def _launch(fn, r, k, v, w, u, S_in, y, B, H, S, Q, K, in_strides,
            y_strides):
    if K not in SUPPORTED_K or not 1 <= Q <= MAX_Q:
        raise ValueError(f"{fn}: Q={Q}, K={K} has no kernel instance; Q in "
                         f"1..{MAX_Q}, K in {SUPPORTED_K}")
    _check_state(fn, u, S_in, B, H, K)
    S_out = torch.empty_like(S_in)
    lib = load("wkv6")
    with torch.cuda.device(r.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.wkv6_seq_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), S_in.data_ptr(), y.data_ptr(), S_out.data_ptr(),
            B, H, S, Q, K, *in_strides, *y_strides, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error "
                           f"{rc} ({error_string('wkv6', rc)})")
    LAUNCHES["wkv6_seq"] += 1
    return y, S_out


def wkv6_seq(r, k, v, w, u, S_in, chunk: int):
    """The chunked WKV6 scan of one layer: r/k/v/w [B,S,H,K], u [H,K],
    S_in [B,H,K,K] (float32), chunks of min(chunk, S) tokens ->
    (y [B,S,H,K], S_final [B,H,K,K])."""
    _check("wkv6_seq", r, k, v, w, u, S_in, "[B, S, H, K]")
    B, S, H, K = r.shape
    y = torch.empty((B, S, H, K), dtype=torch.float32, device=r.device)
    sb, ss, sh = r.stride()[:3]
    return _launch("wkv6_seq", r, k, v, w, u, S_in, y, B, H, S,
                   min(int(chunk), S), K, (sb, ss, sh), y.stride()[:3])


def wkv6_chunk(r, k, v, w, u, S_in):
    """One RWKV-6 chunk: r/k/v/w [B,H,Q,K], u [H,K], S_in [B,H,K,K]
    (float32) -> (y [B,H,Q,K], S_out [B,H,K,K])."""
    _check("wkv6_chunk", r, k, v, w, u, S_in, "[B, H, Q, K]")
    B, H, Q, K = r.shape
    y = torch.empty((B, H, Q, K), dtype=torch.float32, device=r.device)
    sb, sh, sq = r.stride()[:3]
    yb, yh, yq = y.stride()[:3]
    return _launch("wkv6_chunk", r, k, v, w, u, S_in, y, B, H, Q, Q, K,
                   (sb, sq, sh), (yb, yq, yh))
