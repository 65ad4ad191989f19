"""Build and load the fp8 CUDA kernels (``csrc/fp8_matmul.cu``) through the
shared nvcc -> ``.so`` -> ctypes build module (``kernels/build.py``)."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels import build as _build
from repro_torch.kernels.build import I, I64, P

SOURCE = Path(__file__).resolve().parent / "csrc" / "fp8_matmul.cu"

_MATMUL = (P, I, P, I, P, P, I, I, I, I, I, P)
_MIXED = (P, I, P, I, P, P, P, I, P, P, I, I, I, I, I, I, P)
SIGNATURES = (
    # (name, argtypes); every function returns its cudaError_t as int
    ("f8_row_quantize", (P, I, P, P, I, I, I, P)),
    ("f8_tensor_quantize", (P, I, I64, P, P, P, P, I, P)),
    ("f8_tensor_quantize_drop", (P, I, I64, P, P, P, P, I, I, P)),
    ("f8_tensor_quantize_plan", (P, I, P, I64, P)),
    ("f8_tensor_quantize_kt", (P, I, I64, I64, P, P, P, P, P, I, P)),
    ("f8_tensor_quantize_kt_fault", (P, I, I64, I64, P, P, P, P, P, I, I, I, P)),
    ("f8_tensor_quantize_kt_plan", (P, I, P, P, I64, I64, P)),
    ("f8_block_quantize", (P, I, P, P, I, I, I, I, I, P)),
    ("f8_matmul_dequant_t", _MATMUL),
    ("f8_mixed_matmul_t", _MIXED),
    ("f8_transpose_bytes", (P, P, I, I, P)),
    ("f8_wgmma_probe", (P, P, P, I, I, P)),
    ("f8_encode_check", (I, P, P)),
    ("f8_divide_check", (P, P)),
)


def build() -> tuple[Path, str]:
    """Compile the library if needed: (its path, the compiler's log)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The built library with every entry point's signature declared
    (cached here too: the wrappers call this on every launch)."""
    return _build.load(SOURCE, SIGNATURES)
