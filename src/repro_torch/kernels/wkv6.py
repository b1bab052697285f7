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

Training (:class:`WKV6SeqFn`): the forward also writes each chunk's
incoming state ([B, H, C, K, K], C = ceil(S / Q)), and the backward is
the hand-written ``csrc/wkv6_bwd.cu``: one C call per layer that
launches four kernels, the chunk-local carry terms (into a scratch
[B, H, C, K, K] allocated here), the scan of the dS carry over chunks,
the chunk-parallel gradients on a persistent grid, and du summed over
chunks, then b, in order: dr, dk, dv, dw, du and dS_in.  The plain
gradient is autograd's of ``ref.wkv6_seq_plain``
(``ref.wkv6_seq_grads_plain``); ``ref.wkv6_seq_grads_chunked`` writes
out the kernels' three passes.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import aligned, error_string, load

SUPPORTED_K = (32, 64)          # csrc instances
MAX_Q = 64                      # shared-memory sizing of the kernel

# launches since the last reset_launches()
LAUNCHES = {"wkv6_seq": 0, "wkv6_seq_bwd": 0}
# dy tensors the backward had to copy to a layout its kernel reads
COPIES = {"wkv6_seq_bwd.dy": 0}


def reset_launches() -> None:
    for c in (LAUNCHES, COPIES):
        for key in c:
            c[key] = 0


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


def _instance(fn, Q, K):
    if K not in SUPPORTED_K or not 1 <= Q <= MAX_Q:
        raise ValueError(f"{fn}: Q={Q}, K={K} has no kernel instance; Q in "
                         f"1..{MAX_Q}, K in {SUPPORTED_K}")


def _launch(fn, r, k, v, w, u, S_in, y, B, H, S, Q, K, in_strides,
            y_strides, S_chunks=None):
    _instance(fn, Q, K)
    _check_state(fn, u, S_in, B, H, K)
    S_out = torch.empty_like(S_in)
    lib = load("wkv6")
    with torch.cuda.device(r.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.wkv6_seq_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), S_in.data_ptr(), y.data_ptr(), S_out.data_ptr(),
            None if S_chunks is None else S_chunks.data_ptr(),
            B, H, S, Q, K, *in_strides, *y_strides, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error "
                           f"{rc} ({error_string('wkv6', rc)})")
    LAUNCHES["wkv6_seq"] += 1
    return y, S_out


def wkv6_seq(r, k, v, w, u, S_in, chunk: int, S_chunks=None):
    """The chunked WKV6 scan of one layer: r/k/v/w [B,S,H,K], u [H,K],
    S_in [B,H,K,K] (float32), chunks of min(chunk, S) tokens ->
    (y [B,S,H,K], S_final [B,H,K,K]).  ``S_chunks`` (the training
    forward's, see :func:`chunk_states`) receives each chunk's incoming
    state."""
    _check("wkv6_seq", r, k, v, w, u, S_in, "[B, S, H, K]")
    B, S, H, K = r.shape
    y = torch.empty((B, S, H, K), dtype=torch.float32, device=r.device)
    sb, ss, sh = r.stride()[:3]
    return _launch("wkv6_seq", r, k, v, w, u, S_in, y, B, H, S,
                   min(int(chunk), S), K, (sb, ss, sh), y.stride()[:3],
                   S_chunks)


def chunk_states(r, chunk: int):
    """The scratch a training forward fills: [B, H, C, K, K] float32, C =
    ceil(S / Q) chunks of Q = min(chunk, S) tokens (r [B, S, H, K])."""
    B, S, H, K = r.shape
    Q = min(int(chunk), S)
    return torch.empty((B, H, -(-S // Q), K, K), dtype=torch.float32,
                       device=r.device)


def wkv6_seq_bwd(r, k, v, w, u, S_chunks, dy, dS_final, chunk: int):
    """The gradients of :func:`wkv6_seq` at (r, k, v, w, u, S_in) given
    the forward's chunk states, dy [B,S,H,K] and dS_final [B,H,K,K]
    (None: zeros) -> (dr, dk, dv, dw [B,S,H,K], du [H,K], dS_in
    [B,H,K,K]): one C call (four kernels, counted as one launch) with a
    float32 scratch of [B,H,C,K,K] + 2·[B,H,C,K], du summed over chunks,
    then b, in order."""
    _check("wkv6_seq_bwd", r, k, v, w, u, S_chunks, "[B, S, H, K]")
    B, S, H, K = r.shape
    Q = min(int(chunk), S)
    _instance("wkv6_seq_bwd", Q, K)
    if tuple(u.shape) != (H, K) or not u.is_contiguous():
        raise ValueError(f"wkv6_seq_bwd: u must be contiguous [{H}, {K}], "
                         f"got {tuple(u.shape)}")
    if (tuple(S_chunks.shape) != (B, H, -(-S // Q), K, K)
            or not S_chunks.is_contiguous()):
        raise ValueError(f"wkv6_seq_bwd: S_chunks must be the forward's "
                         f"contiguous [B, H, C, K, K], got "
                         f"{tuple(S_chunks.shape)}")
    if dy is None:
        dy = torch.zeros_like(r)
    if dy.shape != r.shape or dy.dtype != torch.float32:
        raise ValueError(f"wkv6_seq_bwd: dy must be float32 "
                         f"{tuple(r.shape)}, got {tuple(dy.shape)} "
                         f"{dy.dtype}")
    if dy.stride(-1) != 1 or not aligned(dy):   # the kernels' 16-byte copies
        dy = dy.contiguous()
        COPIES["wkv6_seq_bwd.dy"] += 1
    if dS_final is not None:
        _check_state("wkv6_seq_bwd", u, dS_final, B, H, K)
    dev = r.device
    grads = [torch.empty((B, S, H, K), dtype=torch.float32, device=dev)
             for _ in range(4)]
    du = torch.empty((H, K), dtype=torch.float32, device=dev)
    dS_in = torch.empty((B, H, K, K), dtype=torch.float32, device=dev)
    C = S_chunks.shape[2]
    carry = torch.empty((B, H, C, K, K), dtype=torch.float32, device=dev)
    ecl = torch.empty((B, H, C, K), dtype=torch.float32, device=dev)
    du_part = torch.empty((B, H, C, K), dtype=torch.float32, device=dev)
    lib = load("wkv6_bwd")
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.wkv6_seq_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), S_chunks.data_ptr(), dy.data_ptr(),
            None if dS_final is None else dS_final.data_ptr(),
            *(g.data_ptr() for g in grads), du.data_ptr(), dS_in.data_ptr(),
            carry.data_ptr(), ecl.data_ptr(), du_part.data_ptr(),
            B, H, S, Q, K, *r.stride()[:3], *dy.stride()[:3],
            *grads[0].stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_seq_bwd: kernel launch failed with CUDA "
                           f"error {rc} ({error_string('wkv6_bwd', rc)})")
    LAUNCHES["wkv6_seq_bwd"] += 1
    return (*grads, du, dS_in)


def bwd_resources(K: int) -> dict:
    """The backward's chunk kernel on this card at K: CTAs an SM holds
    (its persistent grid is that times the SMs), its dynamic shared
    memory and the carry kernel's, in bytes."""
    out = (ctypes.c_int * 3)()
    lib = load("wkv6_bwd")
    rc = lib.wkv6_bwd_resources(int(K), out)
    if rc != 0:
        raise RuntimeError(f"wkv6_bwd_resources: CUDA error {rc} "
                           f"({error_string('wkv6_bwd', rc)})")
    return {"chunk_ctas_per_sm": out[0], "chunk_smem_bytes": out[1],
            "carry_smem_bytes": out[2]}


class WKV6SeqFn(torch.autograd.Function):
    """B7's layer call with its hand-written backward: the forward is one
    launch that also writes each chunk's incoming state; r, k, v, w, u
    and those states are saved as they are (no copy)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, S_in, chunk: int):
        S_chunks = chunk_states(r, chunk)
        y, S_out = wkv6_seq(r, k, v, w, u, S_in, chunk, S_chunks)
        ctx.save_for_backward(r, k, v, w, u, S_chunks)
        ctx.chunk = int(chunk)
        ctx.set_materialize_grads(False)
        return y, S_out

    @staticmethod
    def backward(ctx, dy, dS_final):
        r, k, v, w, u, S_chunks = ctx.saved_tensors
        dr, dk, dv, dw, du, dS_in = wkv6_seq_bwd(r, k, v, w, u, S_chunks, dy,
                                                 dS_final, ctx.chunk)
        return dr, dk, dv, dw, du, dS_in, None


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
