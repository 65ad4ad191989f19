"""Build and load the paged-attention CUDA kernels
(``csrc/paged_attention.cu``) through the shared nvcc -> ``.so`` -> ctypes
build module (``kernels/build.py``)."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels import build as _build
from repro_torch.kernels.build import F32, I, P

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"

SIGNATURES = (
    # (name, argtypes); every function returns its cudaError_t as int
    ("pa_paged_decode_fwd", (P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F32, P)),
    ("pa_paged_prefill_fwd", (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F32, P)),
)


def build() -> tuple[Path, str]:
    """Compile the library if needed: (its path, the compiler's log)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The built library with every entry point's signature declared
    (cached here too: the wrappers call this on every launch)."""
    return _build.load(SOURCE, SIGNATURES)
