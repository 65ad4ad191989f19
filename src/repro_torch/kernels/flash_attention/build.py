"""Build and load the flash-attention CUDA kernels
(``csrc/flash_attention.cu``) through the shared nvcc -> ``.so`` -> ctypes
build module (``kernels/build.py``)."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels import build as _build
from repro_torch.kernels.build import F32, I, P

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

SIGNATURES = (
    # (name, argtypes); every function returns its cudaError_t as int
    ("fa_flash_fwd", (P, P, P, P, P, I, I, I, I, I, I, I, I, I, F32, P)),
    ("fa_decode_fwd", (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F32, P)),
    ("fa_flash_bwd_dq", (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F32, P)),
    ("fa_flash_bwd_dkv", (P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F32, P)),
    # chip_smoke.py's accumulator probe of one mma.sync step chain
    ("fa_mma_probe", (P, P, P, I, P)),
)


def build() -> tuple[Path, str]:
    """Compile the library if needed: (its path, the compiler's log)."""
    return _build.build(SOURCE)


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The built library with every entry point's signature declared
    (cached here too: the wrappers call this on every launch)."""
    return _build.load(SOURCE, SIGNATURES)
