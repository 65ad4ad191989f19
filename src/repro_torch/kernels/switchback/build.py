"""Build and load the SwitchBack CUDA kernels (``csrc/switchback.cu``).

The source has a plain C interface, so ``nvcc`` compiles it into a shared
library in seconds and ``ctypes`` loads it — no PyTorch headers, no
extension module. The library is built at first use into ``build/`` at the
root of the checkout, named by a hash of the source and flags, so an edited
source never loads a stale library. Nothing here runs at import time: the
CPU tests import this module on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "switchback.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"

# sm_90a: Hopper with its arch-specific instructions. No --use_fast_math:
# the quantizers need IEEE division (the kernels also pin it with __fdiv_rn).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # name: argtypes (every function returns its cudaError_t as int)
    "sb_row_quantize": (_P, _I, _P, _P, _I, _I, _P),
    "sb_tensor_quantize": (_P, _I, _I64, _P, _I, _P, _P, _P),
    "sb_fused_switchback_fwd": (_P, _I, _P, _P, _P, _I, _I, _I, _P),
    "sb_int8_matmul_dequant": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the SwitchBack CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"switchback_{digest}.so"


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet. Returns its path and the
    compiler's log (``-Xptxas -v``: registers, shared memory and spills per
    kernel; empty when the library was already there). Raises with the
    compiler's output when ``nvcc`` fails."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)          # atomic: a concurrent loader sees all or nothing
    return out, res.stdout + res.stderr


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The built library with every entry point's signature declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
