"""Plain PyTorch version of the fp8 cast kernel.

It repeats the Pallas kernel's arithmetic (``repro/kernels/fp8_cast/
fp8_cast.py:22``), operation by operation, and so the CUDA kernel's:
the reciprocal ``1 / max(absmax, 1e-12)`` as one IEEE division of tensors
(``core/quantization.div``), then the product with x in f32, the clip to
the format's range, ``fp8_grid_round``, the cast to the fp8 dtype (exact)
and the widening to f32. The JAX package's XLA path and its ``ref.py``
divide x / absmax instead, which lands on the other fp8 neighbour where
the two f32 values straddle a tie; the port follows the kernel. Not
``kernels/fp8_matmul/ref.py``'s ``cast``, which divides too.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantization as Q

_EPS = 1e-12


def fp8_cast_tensorwise(x: torch.Tensor, absmax: torch.Tensor, fmt: str = "e4m3"
                        ) -> torch.Tensor:
    """x (R, C) any float, absmax one f32 value -> (R, C) f32 of exact fp8
    values: fp8(clip(x * (1 / max(absmax, 1e-12)), +-fmax))."""
    inv = Q.div(1.0, absmax.float().reshape(()).clamp_min(_EPS))
    fmax = Q.FP8_MAX[fmt]
    scaled = (x.float() * inv).clamp(-fmax, fmax)
    return Q.fp8_grid_round(scaled, fmt).to(Q.FP8_DTYPES[fmt]).float()
