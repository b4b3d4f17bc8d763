"""Build and load the hand-written Hopper LUT kernels (``csrc/*.cu``).

The CUDA source has a plain ``extern "C"`` interface, so it is compiled
with ``nvcc`` alone into a shared library and bound with ``ctypes``:
seconds to build, where a source that includes PyTorch's headers takes
minutes.  The library is built at first use, never at import, into
``build/repro_torch_kernels/`` at the root of the checkout (``build/`` is
listed in ``.gitignore``), under a name keyed by the source's hash, so a
changed source is rebuilt and an unchanged one is loaded as it is.

A failed build raises; nothing here falls back to the plain versions.
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
SOURCE = CSRC / "lut_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every entry point: pointers and the stream as c_void_p, sizes
# as c_int (an unset argtype would pass a Python int as a 32-bit int and cut
# the pointer)
_SIGNATURES = {
    "lut_mixed_forward": (_P, _I, _I, _P, _P, _P, _I, _P, _I, _P, _P, _I, _P,
                          _I, _I, _I, _P, _P),
    "lut_uniform_forward": (_P, _I, _I, _P, _I, _P, _I, _I, _P, _I, _P, _I,
                            _I, _I, _P, _P),
    "lut_layer_forward": (_P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_builds = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"liblut_kernels_{digest}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/lut_kernels.cu`` unless its library already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, end="")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib, _builds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.lut_error_string.argtypes = [ctypes.c_int]
            lib.lut_error_string.restype = ctypes.c_char_p
            _builds += 1
            _lib = lib
    return _lib


def builds() -> int:
    """How many times this process built or loaded the kernel library.

    The port's counterpart of the reference's jit cache size: a serving
    loop warms the library up once, and the count must not grow after.
    """
    return _builds


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err:
        msg = library().lut_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} "
                           f"(cudaError_t {err})")
