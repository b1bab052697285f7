"""The math of B7's backward kernels (``csrc/wkv6_bwd.cu``) on the CPU.

``ref.wkv6_seq_grads_chunked`` writes out the kernels' three passes in
plain PyTorch: the chunk-local carry terms P_c = RS_cᵀ·dy_c, the carry
scan over chunks, and the chunk-parallel gradients from each chunk's
inputs, its incoming state and its dS_out.  It is held against autograd
of ``ref.wkv6_seq_plain`` (``ref.wkv6_seq_grads_plain``) and against
``jax.vjp`` of the JAX model's ``rwkv6._wkv_chunked`` on the same numpy
inputs: K 32 and 64; S of one chunk, below one chunk, with a ragged last
chunk and over several chunks; per-token decay in (e^-1, 1) and down to
e^-3 (the ±40 clips and the -80 floors bite from the second token on a
64-token chunk); dS_final given and not.

Tolerance: each gradient within 2e-5 of its largest |value| (the three
forms sum in other orders: the scan over chunks, the suffix sum, the
matrix products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as JR6
from repro_torch.kernels import ref

TOL = 2e-5
NAMES = ("dr", "dk", "dv", "dw", "du", "dS_in")
# (S, chunk): one chunk, below one chunk, a ragged last chunk, several
# chunks (the last ragged), several whole chunks
SHAPES = ((64, 64), (40, 64), (100, 64), (200, 64), (192, 32))


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def inputs(B, S, H, K, decay, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)    # noqa: E731
    r, k, v = f(B, S, H, K), f(B, S, H, K), f(B, S, H, K)
    w = np.exp(-decay * rng.random((B, S, H, K))).astype(np.float32)
    return r, k, v, w, f(H, K), f(B, H, K, K), f(B, S, H, K), f(B, H, K, K)


@pytest.mark.parametrize("final", [True, False])
@pytest.mark.parametrize("decay", [1.0, 3.0])
@pytest.mark.parametrize("K", [32, 64])
@pytest.mark.parametrize("S,chunk", SHAPES)
def test_chunked_backward_matches_autograd_and_jax(S, chunk, K, decay,
                                                   final):
    H = 8 if K == 32 else 4
    r, k, v, w, u, S0, dy, dSf = inputs(2, S, H, K, decay,
                                        seed=S + K + int(decay))
    if decay > 2 and min(S, chunk) == 64:
        assert np.cumsum(np.log(w[:, :64]), axis=1).min() < -80
    ins = [torch.from_numpy(x) for x in (r, k, v, w, u, S0)]
    dS = torch.from_numpy(dSf) if final else None
    got = ref.wkv6_seq_grads_chunked(*ins, chunk, torch.from_numpy(dy), dS)
    plain = ref.wkv6_seq_grads_plain(*ins, chunk, torch.from_numpy(dy), dS)
    f = lambda *x: JR6._wkv_chunked(*x, chunk)              # noqa: E731
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (r, k, v, w, u, S0)))
    jax_g = vjp((jnp.asarray(dy),
                 jnp.asarray(dSf if final else np.zeros_like(dSf))))
    for name, a, b, c in zip(NAMES, got, plain, jax_g):
        assert rel_err(a, b) <= TOL, (name, "autograd", rel_err(a, b))
        assert rel_err(a, c) <= TOL, (name, "jax", rel_err(a, c))


def test_the_carry_scan_runs_from_the_last_chunk():
    """With dy = 0 only the carry moves: dS_in is dS_final decayed by
    every chunk's e^{max(cl, -80)}, row by row, and r and u (which reach
    y alone) get no gradient."""
    r, k, v, w, u, S0, _, dSf = inputs(1, 130, 2, 32, 1.0, seed=3)
    ins = [torch.from_numpy(x) for x in (r, k, v, w, u, S0)]
    got = ref.wkv6_seq_grads_chunked(*ins, 64, torch.zeros(1, 130, 2, 32),
                                     torch.from_numpy(dSf))
    cl = [np.log(w[:, c0:c0 + 64]).astype(np.float64).sum(1)
          for c0 in (0, 64, 128)]
    decay = np.exp(np.maximum(sum(cl), -80.0))[0]           # [H, K]
    np.testing.assert_allclose(got[5].numpy()[0], decay[..., None] * dSf[0],
                               rtol=1e-5, atol=1e-30)
    for g in (got[0], got[4]):
        assert not g.abs().max()
