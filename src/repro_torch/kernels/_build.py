"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> one shared
library per source, with a plain C interface, bound with ctypes).

The build runs at first use, reads only the sources in this package and
writes into ``build/kernels/`` at the repository root (git-ignored).
Each library's file name carries a hash of its source, of the shared
headers in ``csrc/`` and of the nvcc flags, so an edited kernel is never
served from a stale build.
:func:`build_all` starts one nvcc per source at once and waits for all
of them; :class:`Builds` starts them and waits for the ones asked for.  A missing ``nvcc`` or a failed build raises: there is no
fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "brsgd_stats.cu"
SOURCES = {"brsgd_stats": SOURCE,
           "brsgd_bucket": CSRC / "brsgd_bucket.cu",
           "flash_attention": CSRC / "flash_attention.cu",
           "flash_attention_bwd": CSRC / "flash_attention_bwd.cu",
           "wkv6": CSRC / "wkv6.cu",
           "wkv6_bwd": CSRC / "wkv6_bwd.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills per kernel)
# of each library built in this process; a reused library has no entry
BUILD_LOGS: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# every C entry of each library: argument types (the return type is int)
SIGNATURES = {
    "brsgd_stats": {
        "brsgd_threads": (),
        "brsgd_max_blocks": (),
        # G, m, d, needs, scores/l1/d2med/gram partials (nullable), grid,
        # ring stages (unused with gram), stream
        "brsgd_fused_stats": (_P, _I, _L, _I, _P, _P, _P, _P, _I, _I, _P),
        # G, m, d, median, mean, scores/l1 partials, grid, stages, stream
        "brsgd_column_stats": (_P, _I, _L, _P, _P, _P, _P, _I, _I, _P),
        # G, m, d, median, grid, stages, stream
        "brsgd_cwise_median": (_P, _I, _L, _P, _I, _I, _P),
        # m, variant, dynamic shared memory, int* count
        "brsgd_column_coresident": (_I, _I, _L, _P),
        "brsgd_select_mean": (_P, _I, _L, _P, _P, _P, _P, _I, _P),
        # G, m, d, w (null: unit weights), out, small_out (nullable),
        # n_blocks, stream
        "brsgd_masked_mean": (_P, _I, _L, _P, _P, _P, _I, _P),
        # G, m, d, k, out, grid, stages, stream
        "brsgd_trimmed_mean": (_P, _I, _L, _I, _P, _I, _I, _P),
        # G, m, d, rule, ia, ib, fa, resident, partials, small_out, out,
        # grid, stream (brsgd: ia, ib, fa = k_idx, q_idx, threshold)
        "brsgd_select_aggregate": (_P, _I, _L, _I, _I, _I, _F, _I, _P, _P,
                                   _P, _I, _P),
        "brsgd_select_aggregate_coresident": (_I, _I, _L, _P),
    },
    "flash_attention": {
        # q, k, v, o, lse (nullable), dtype, B, H, Hkv, S, T, D, Dv,
        # 4 x (b, h, s) strides, window, stream
        "flash_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                _L, _L, _L, _I, _P),
    },
    "flash_attention_bwd": {
        # q, k, v, o, dO, lse, di, dq, dk, dv, B, H, Hkv, S, T, D, Dv,
        # 8 x (b, h, s) strides (q, k, v, o, dO, dq, dk, dv), window, stream
        "flash_attention_bwd": (_P,) * 10 + (_I,) * 7 + (_L,) * 24
                               + (_I, _P),
        # D, Dv, int out[4]: dK/dV and dQ CTAs an SM holds, their shared
        # memory
        "flash_bwd_ctas_per_sm": (_I, _I, _P),
    },
    "wkv6": {
        # r, k, v, w, u, S0, y, S_out, S_chunks (nullable), B, H, S, Q, K,
        # input strides (batch, token, head), y strides, stream
        "wkv6_seq_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _L, _L, _L, _L, _L, _L, _P),
    },
    "wkv6_bwd": {
        # r, k, v, w, u, S_chunks, dy, dS_final (nullable), dr, dk, dv, dw,
        # du, dS_in, the scratch (carry terms, e^{max(cl, -80)}, du
        # partials), B, H, S, Q, K, input, dy and gradient strides (batch,
        # token, head), stream
        "wkv6_seq_bwd": (_P,) * 17 + (_I,) * 5 + (_L,) * 9 + (_P,),
        # K, int out[3]: chunk-kernel CTAs an SM, its shared memory, the
        # carry kernel's
        "wkv6_bwd_resources": (_I, _P),
    },
}
# the bucket instances (any other m <= 64) have the tuned library's entries
SIGNATURES["brsgd_bucket"] = SIGNATURES["brsgd_stats"]
ERROR_STRING = {"brsgd_stats": "brsgd_error_string",
                "brsgd_bucket": "brsgd_error_string",
                "flash_attention": "flash_error_string",
                "flash_attention_bwd": "flash_bwd_error_string",
                "wkv6": "wkv6_error_string",
                "wkv6_bwd": "wkv6_bwd_error_string"}


def expanded_source(name: str = "brsgd_stats") -> str:
    """A library's source as nvcc compiles it: its ``#include "..."`` of
    the headers in ``csrc/`` replaced by their text (once each)."""
    seen = set()

    def expand(text: str) -> str:
        def include(m):
            header = m.group(1)
            if header in seen:
                return ""
            seen.add(header)
            return expand((CSRC / header).read_text())
        return re.sub(r'^#include "([^"]+)"$', include, text, flags=re.M)
    return expand(SOURCES[name].read_text())


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return nvcc


def library_path(source: Path = SOURCE) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # shared by the sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc on one source; None when its library already exists."""
    source = SOURCES[name]
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return cmd, proc, tmp, out


def _finish(name: str, job) -> None:
    cmd, proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    BUILD_LOGS[name] = log


def build(name: str = "brsgd_stats") -> Path:
    """Compile one source if it has no library yet; returns the
    library's path.  Raises RuntimeError with nvcc's output on a failed
    build."""
    job = _start(name)
    if job is not None:
        _finish(name, job)
    return library_path(SOURCES[name])


class Builds:
    """Every source without a library compiling at once: one nvcc each,
    started together, each read to its end by a thread of its own (so no
    nvcc stalls on a full output pipe).  :meth:`wait` blocks until the
    named libraries are built, so a caller can use the quick ones while
    the slow ones compile."""

    def __init__(self):
        self._threads, self._errors = {}, {}
        for name in SOURCES:
            job = _start(name)
            if job is not None:
                t = threading.Thread(target=self._finish, args=(name, job),
                                     daemon=True)
                t.start()
                self._threads[name] = t

    def _finish(self, name, job):
        try:
            _finish(name, job)
        except RuntimeError as e:
            self._errors[name] = str(e)

    def wait(self, names=None) -> dict:
        """Waits for the libraries ``names`` (default: all) and returns
        {name: library path}; raises, after they have all ended, if any
        of them failed to build."""
        names = list(SOURCES) if names is None else list(names)
        for name in names:
            if name in self._threads:
                self._threads[name].join()
        errors = [self._errors[n] for n in names if n in self._errors]
        if errors:
            raise RuntimeError("\n".join(errors))
        return {name: library_path(SOURCES[name]) for name in names}


def build_all() -> dict:
    """Compile every source that has no library yet, all at once; returns
    {name: library path}.  Raises on a failed build, after every nvcc has
    ended."""
    return Builds().wait()


def load(name: str = "brsgd_stats") -> ctypes.CDLL:
    """One kernel library, built on first use, with every entry's
    argument and return types declared."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            for fn_name, args in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            err = getattr(lib, ERROR_STRING[name])
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def aligned(t) -> bool:
    """Every row start of t (4-D, the last dim contiguous) lies on a
    16-byte boundary, as the kernels' 16-byte copies need: the data
    pointer and the three outer strides in bytes are multiples of 16.
    The stride of a dimension of size 1 never moves an address (autograd
    hands out such strides freely), so it is not held to that."""
    es = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s * es % 16 == 0 or n == 1
                    for s, n in zip(t.stride()[:3], t.shape[:3])))


def error_string(name: str, rc: int) -> str:
    return getattr(load(name), ERROR_STRING[name])(rc).decode()
