"""Build, load and launch a CUDA source with a plain C interface.

Each kernel family (``switchback``, ``flash_attention``, ``fp8_matmul``,
``fp8_cast``, ``paged_attention``) keeps one ``.cu`` file under its
``csrc/`` and declares the signatures of its entry points; this module
compiles it with ``nvcc`` into a shared library and loads it with
``ctypes`` — no PyTorch headers, no extension module, seconds per build.
Headers the families share live in ``kernels/csrc/``. The library is
built at first use into ``build/`` at the root of the checkout, named by
a hash of its source, every local header it includes and the flags, so
an edited source or header never loads a stale library and editing one
family never rebuilds another. Nothing here runs at import time: the CPU tests import
the kernel modules on a host without ``nvcc``. The wrappers of every
family share the device dispatch and launch helpers at the end.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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


_LOCAL_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def source_files(source: Path) -> list[Path]:
    """``source`` and every local header it includes, transitively, each
    once: the ``#include "..."`` lines, resolved from the including file's
    directory as ``nvcc`` resolves them first (a name found there only on
    the include path is not the checkout's, and is left out)."""
    seen, todo = [], [source.resolve()]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for name in _LOCAL_INCLUDE.findall(path.read_text()):
            header = (path.parent / name).resolve()
            if header.is_file():
                todo.append(header)
    return seen


def library_path(source: Path) -> Path:
    """Where ``source``'s library is built: named by a hash of the bytes of
    every file ``source_files`` lists and of the flags."""
    h = hashlib.sha256()
    for path in source_files(source):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


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


_BARRIERS: dict = {}      # (device index, stream) -> the tensor quantizers' barrier workspace


def grid_barrier(device: torch.device, st: int) -> torch.Tensor:
    """The two-word workspace of the tensor quantizers' grid barrier
    (``kernels/csrc/tensor_absmax.cuh``: arrivals, then an epoch) for the
    stream ``st`` (``stream(t)``) of ``device``: int32 zeros when made, and
    every launch leaves the arrivals 0. One a stream, since a launch may
    not share it with a launch that runs beside it; kept for the process's
    life, since a captured CUDA graph holds its address."""
    key = (device.index, st)
    if key not in _BARRIERS:
        _BARRIERS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _BARRIERS[key]


def plan(entry, x: torch.Tensor) -> dict:
    """A tensor quantizer's launch plan for ``x`` (and a q as the wrapper
    allocates it, 256-byte aligned), from its C entry point ``entry``:
    its blocks, its rounds (0: the one launch; else the two passes'
    rounds), the granule (values a load), the one-launch kernel's resident
    blocks and the values a block holds in one round. Host only; it loads
    the library, so it needs the card's toolchain."""
    out = (ctypes.c_int * 5)()
    launch(entry, x.data_ptr(), int(x.dtype == torch.bfloat16), None, x.numel(),
           ctypes.addressof(out))
    return dict(zip(("blocks", "rounds", "granule", "resident", "block_values"), out))


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2``'s head: the function, then the fields
    the readers here do not use (room for the rest of the struct)."""
    _fields_ = [("func", ctypes.c_void_p), ("rest", ctypes.c_byte * 256)]


def graph_kernels(fn) -> list:
    """The CUDA kernels one ``fn()`` launches, in node order: the kernel
    nodes of a CUDA graph that captures it, read through libcuda
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``), each by its name
    (``cuGraphKernelNodeGetParams`` and ``cuFuncGetName``; None where
    libcuda gives none). Exact where torch.profiler's records can go
    missing, and blind to which code launched a kernel. ``fn`` runs once
    on the capture stream first, so that per-stream workspaces (the grid
    barrier) are made outside the capture. Card only."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")

    def call(name, *args):
        err = getattr(cu, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUresult {err}")

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", raw, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", raw, nodes, ctypes.byref(n))
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:                       # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params, name = _KernelNodeParams(), ctypes.c_char_p()
        ok = (cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)) == 0
              and params.func and cu.cuFuncGetName(ctypes.byref(name),
                                                   ctypes.c_void_p(params.func)) == 0)
        names.append(name.value.decode() if ok and name.value else None)
    graph.reset()
    return names
