"""Public wrapper for the fp8 cast kernel: dispatch by device.

The port of ``repro/kernels/fp8_cast/ops.py``. A tensor on the CPU goes
to the plain version in ``ref.py``; a tensor on the card to the
hand-written CUDA kernel (``csrc/fp8_cast.cu``), or the wrapper raises:
there is no backend argument and no fallback when the build or a launch
fails. The JAX op's ``backend="xla"`` divides where its Pallas kernel
multiplies by the reciprocal; the port computes the kernel's function on
both devices (``ref.py``).

No serve or train path calls it (the ``fp8_sim`` mode rounds with
``core/quantization.fp8_cast``, as the JAX package's does): it is the op
entry point the JAX package's benchmark and tests call. The wrapper counts
its launches in ``LAUNCHES``, incremented only where it launches its
kernel; ``launch_counts``/``reset_launch_counts`` read and zero them.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import FP8_MAX
from repro_torch.kernels import build as _b
from repro_torch.kernels.fp8_cast import ref as _ref

_FMT_CODE = {"e4m3": 0, "e5m2": 1}
_FLOAT_TYPES = (torch.float32, torch.bfloat16)

LAUNCHES = {"fp8_cast_tensorwise": 0}


def _lib():
    from repro_torch.kernels.fp8_cast.build import load
    return load()


def fp8_cast_tensorwise(x: torch.Tensor, absmax: torch.Tensor, fmt: str = "e4m3"
                        ) -> torch.Tensor:
    """x (R, C) f32/bf16, absmax one f32 value (any shape of one element)
    -> (R, C) f32 holding fp8(clip(x * (1 / max(absmax, 1e-12)), +-fmax))."""
    _b.need(x, "x", _FLOAT_TYPES, 2)
    if fmt not in FP8_MAX:
        raise ValueError(f"fmt {fmt!r} not in {sorted(FP8_MAX)}")
    if absmax.dtype != torch.float32 or absmax.numel() != 1:
        raise TypeError(f"absmax must be one float32 value, got {absmax.dtype} "
                        f"of shape {tuple(absmax.shape)}")
    if _b.on_cpu(x, absmax):
        return _ref.fp8_cast_tensorwise(x, absmax, fmt)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _b.launch(_lib().fc_fp8_cast_tensorwise, x.data_ptr(), int(x.dtype == torch.bfloat16),
              absmax.data_ptr(), out.data_ptr(), x.numel(), _FMT_CODE[fmt], _b.stream(x))
    LAUNCHES["fp8_cast_tensorwise"] += 1
    return out


KERNELS = (fp8_cast_tensorwise,)


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
