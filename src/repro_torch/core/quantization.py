"""int8 quantizers of the paper, Eq. (1) row-wise and Eq. (2) tensor-wise.

The PyTorch counterpart of ``repro/core/quantization.py`` (int8 part only;
the fp8 quantizers come with the fp8 slice). Each quantizer returns
``(q, state)`` with ``state`` the absmax saved for dequantization:
``(..., rows, 1)`` row-wise, a scalar tensor-wise. int8 maps
``x -> round(x * (127 / absmax))``, round half to even.
"""
from __future__ import annotations

import torch

INT8_QMAX = 127.0
# Guard against absmax == 0 (all-zero tensors, e.g. zero-init layer-scale
# outputs at step 0): clamp the scale denominator.
_EPS = 1e-12


def div(a, b) -> torch.Tensor:
    """``a / b`` as one IEEE-rounded f32 division on every device, as the
    JAX package and the CUDA kernels divide. A plain Python number as
    either operand would not do: ``127.0 / t`` is reciprocal(t) * 127, and
    on CUDA ``t / 16129.0`` is t * (1 / 16129) — two roundings each."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a / b


def _absmax(x: torch.Tensor, dim=None) -> torch.Tensor:
    a = x.abs()
    m = a.amax() if dim is None else a.amax(dim=dim, keepdim=True)
    return m.float().clamp_min(_EPS)


def quantize_rowwise(x: torch.Tensor):
    """Row-wise int8, Eq. (1): one scale per row of the last dim. The
    division comes first, then the multiply, then round half to even."""
    state = _absmax(x, dim=-1)
    q = torch.round(x.float() * div(INT8_QMAX, state)).to(torch.int8)
    return q, state


def quantize_tensorwise(x: torch.Tensor):
    """Tensor-wise int8, Eq. (2): one scale for the whole tensor."""
    state = _absmax(x)
    q = torch.round(x.float() * div(INT8_QMAX, state)).to(torch.int8)
    return q, state


def dequantize_rowwise(q: torch.Tensor, state: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    return (q.float() * div(state, INT8_QMAX)).to(dtype)


def dequantize_tensorwise(q: torch.Tensor, state: torch.Tensor,
                          dtype=torch.float32) -> torch.Tensor:
    return (q.float() * div(state, INT8_QMAX)).to(dtype)
