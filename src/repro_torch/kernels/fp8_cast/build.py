"""Build and load the fp8 cast kernel (``csrc/fp8_cast.cu``) through the
shared nvcc -> ``.so`` -> ctypes build module (``kernels/build.py``)."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels import build as _build
from repro_torch.kernels.build import I, I64, P

SOURCE = Path(__file__).resolve().parent / "csrc" / "fp8_cast.cu"

SIGNATURES = (
    # (name, argtypes); the function returns its cudaError_t as int
    ("fc_fp8_cast_tensorwise", (P, I, P, P, I64, I, P)),
)


def build() -> tuple[Path, str]:
    """Compile the library if needed: (its path, the compiler's log)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The built library with the entry point's signature declared (cached
    here too: the wrapper calls this on every launch)."""
    return _build.load(SOURCE, SIGNATURES)
