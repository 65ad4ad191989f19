"""Build, load and launch a CUDA source with a plain C interface.

Each kernel family (``switchback``, ``flash_attention``) keeps one ``.cu``
file under its ``csrc/`` and declares the signatures of its entry points;
this module compiles it with ``nvcc`` into a shared library and loads it
with ``ctypes`` — no PyTorch headers, no extension module, seconds per
build. The library is built at first use into ``build/`` at the root of
the checkout, named by a hash of its own source and the flags, so an
edited source never loads a stale library and editing one family never
rebuilds another. Nothing here runs at import time: the CPU tests import
the kernel modules on a host without ``nvcc``. The wrappers of both
families share the device dispatch and launch helpers at the end.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

# sm_90a: Hopper with its arch-specific instructions. No --use_fast_math:
# the quantizers need IEEE division and the attention kernels IEEE
# expf/logf (the kernels also pin the roundings they depend on).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes argument types for the signature tables
P, I, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


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
                       "the CUDA kernels cannot be built")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{digest}.so"


def build(source: Path) -> tuple[Path, str]:
    """Compile ``source`` if its library is not built yet. Returns the
    library's path and the compiler's log (``-Xptxas -v``: registers,
    shared memory and spills per kernel; empty when the library was
    already there). Raises with the compiler's output when ``nvcc`` fails."""
    out = library_path(source)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)          # atomic: a concurrent loader sees all or nothing
    return out, res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def load(source: Path, signatures: tuple) -> ctypes.CDLL:
    """The built library of ``source`` with every entry point's signature
    declared. ``signatures``: ``((name, argtypes), ...)``; every entry
    point returns its ``cudaError_t`` as an int."""
    path, _ = build(source)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper runs the plain
    version), False when every one lies on the card (it launches the
    kernel); raises on a mix."""
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"kernel ops take tensors all on the CPU or all on the "
                     f"card, got devices {sorted(devs)}")


def need(t: torch.Tensor, name: str, dtypes, ndim: int):
    """Check a wrapper's input: dtype, rank and contiguity (the kernels
    read their operands through their own offsets)."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(fn, *args):
    """Call a C entry point; raise on the ``cudaError_t`` it returns."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: cudaError {err}")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the int the C entry
    points take."""
    return torch.cuda.current_stream(t.device).cuda_stream
