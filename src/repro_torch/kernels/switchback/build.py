"""Build and load the SwitchBack CUDA kernels (``csrc/switchback.cu``)
through the shared nvcc -> ``.so`` -> ctypes build module (``kernels/build.py``)."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels import build as _build
from repro_torch.kernels.build import I, I64, P

SOURCE = Path(__file__).resolve().parent / "csrc" / "switchback.cu"

SIGNATURES = (
    # (name, argtypes); every function returns its cudaError_t as int
    ("sb_row_quantize", (P, I, P, P, I, I, P)),
    ("sb_col_quantize", (P, I, P, P, I, I, P)),
    ("sb_tensor_quantize", (P, I, I64, P, I, P, P, P)),
    ("sb_fused_switchback_fwd", (P, I, P, P, P, I, I, I, P)),
    ("sb_int8_matmul_dequant", (P, P, P, P, P, I, I, I, I, P)),
    ("sb_fused_switchback_dgrad", (P, I, P, P, P, I, I, I, P)),
    ("sb_int8_matmul_dequant_t", (P, P, P, P, P, I, I, I, I, P)),
)


def build() -> tuple[Path, str]:
    """Compile the library if needed: (its path, the compiler's log)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The built library with every entry point's signature declared
    (cached here too: the wrappers call this on every launch)."""
    return _build.load(SOURCE, SIGNATURES)
