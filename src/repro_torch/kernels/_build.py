"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> shared library
with a plain C interface, bound with ctypes).

The build runs at first use, reads only the sources in this package and
writes into ``build/kernels/`` at the repository root (git-ignored).
The library's file name carries a hash of the source, so an edited
kernel is never served from a stale build.  A missing ``nvcc`` or a
failed build raises: there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "brsgd_stats.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_lib = None
# nvcc's -Xptxas -v report of the last build in this process (registers,
# shared memory, spills per kernel); empty when the library was reused
BUILD_LOG = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "brsgd_threads": (),
    "brsgd_max_blocks": (),
    "brsgd_fused_stats": (_P, _I, _L, _I, _P, _P, _P, _P, _I, _P),
    "brsgd_column_stats": (_P, _I, _L, _P, _P, _P, _P, _I, _P),
    "brsgd_select_mean": (_P, _I, _L, _P, _P, _P, _P, _I, _P),
    "brsgd_masked_mean": (_P, _I, _L, _P, _P, _I, _P),
    "brsgd_trimmed_mean": (_P, _I, _L, _I, _P, _I, _P),
}


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


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"brsgd_stats-{digest}.so"


def build() -> Path:
    """Compile the kernels if this source has no library yet; returns
    the library's path.  Raises RuntimeError with nvcc's output on a
    failed build."""
    global BUILD_LOG
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG = proc.stdout + proc.stderr
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every entry's
    argument and return types declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            lib.brsgd_error_string.argtypes = [ctypes.c_int]
            lib.brsgd_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
