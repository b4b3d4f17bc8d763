"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Every CUDA source has a plain ``extern "C"`` interface, so each is
compiled with ``nvcc`` alone (all of them at once, one process each) and
the objects are linked into one shared library bound with ``ctypes``:
seconds to build, where a source that includes PyTorch's headers takes
minutes.  The library is built at first use, never at import, into
``build/repro_torch_kernels/`` at the root of the checkout (``build/`` is
listed in ``.gitignore``), under a name keyed by the hash of every source
and the flags, so a changed source is rebuilt and an unchanged set is
loaded as it is.

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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes of every entry point: pointers and the stream as c_void_p, sizes
# as c_int (an element count as c_longlong), scales as c_float (rounded to
# nearest from the Python float, as a float32 tensor holds it; an unset
# argtype would pass a Python int as a 32-bit int and cut the pointer)
_SIGNATURES = {
    "lut_mixed_forward": (_P, _I, _I, _P, _P, _P, _I, _P, _I, _P, _P, _I, _P,
                          _I, _I, _I, _P, _P),
    "lut_uniform_forward": (_P, _I, _I, _P, _I, _P, _I, _I, _P, _I, _P, _I,
                            _I, _I, _P, _P),
    "lut_mixed_smem_forward": (_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                               _I, _I, _P, _P),
    "lut_uniform_smem_forward": (_P, _I, _I, _P, _P, _I, _P, _P, _P, _I, _I,
                                 _I, _P, _P),
    "lut_layer_smem_forward": (_P, _I, _I, _P, _I, _I, _P, _I, _I, _I, _P,
                               _I, _I, _I, _I, _I, _P),
    "lut_layer_smem_bytes": (_I, _I, _I, _I, _I, _I, _I, _I),
    "masked_matmul_forward": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "masked_matmul_wgmma_forward": (_P, _P, _P, _P, _I, _I, _I, _P, _P),
    "masked_matmul_swiglu_quant_wgmma_forward": (_P, _P, _P, _P, _I, _I, _I,
                                                 _F, _F, _P, _P),
    "quant_relu_bf16_forward": (_P, _L, _F, _F, _P, _P),
    "masked_matmul_ffma_forward": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                                   _P),
    "flash_attention_forward": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _F, _I, _P),
    "flash_attention_wgmma_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _I, _I, _F, _P),
    "flash_attention_wgmma_forward_train": (_P, _P, _P, _P, _P, _P, _P, _I,
                                            _I, _I, _I, _I, _I, _I, _F, _P),
    "flash_attention_wgmma_backward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _I, _I, _I, _I, _I, _I, _I, _F,
                                       _P),
    "flash_attention_tf32_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _I, _I, _F, _P),
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


def sources() -> list[Path]:
    """Every CUDA source of the library, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """The library's path, keyed by the flags and every source and header
    (``csrc/*.cu`` and ``csrc/*.cuh``), so a changed header rebuilds it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources(), *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def _nvcc_all(cmds: list[list[str]]) -> str:
    """Run the ``nvcc`` commands at once; raise naming the first that
    failed, else return their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, logs):
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return "".join(logs)


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` unless their library already exists.

    Each source compiles in its own ``nvcc`` process, all started
    together; one more ``nvcc`` links the objects.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{BUILD_DIR / out.stem}.{os.getpid()}"
    nvcc, ptxas = _nvcc(), (["-Xptxas", "-v"] if verbose else [])
    srcs = sources()
    objs = [f"{tag}.{src.stem}.o" for src in srcs]
    log = _nvcc_all([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, str(src)]
                     for obj, src in zip(objs, srcs)])
    log += _nvcc_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tag}.tmp",
                       *objs]])
    for obj in objs:
        os.unlink(obj)
    if verbose:
        print(log, end="")
    os.replace(f"{tag}.tmp", out)
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
