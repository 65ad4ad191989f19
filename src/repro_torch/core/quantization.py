"""The paper's quantizers: int8 Eq. (1) row-wise, Eq. (2) tensor-wise and
the column-wise weight state of Eq. (4); and the fp8 "exact value"
quantizers of §2.2.1 (E4M3 and E5M2).

The PyTorch counterpart of ``repro/core/quantization.py``. Each quantizer
returns ``(q, state)`` with ``state`` the absmax saved for
dequantization: ``(..., rows, 1)`` row-wise, ``(..., 1, cols)``
column-wise, a scalar tensor-wise. int8 maps
``x -> round(x * (127 / absmax))``, round half to even. fp8 maps
``x -> fp8_grid_round(x / absmax)``: the quantized values lie in [-1, 1]
on the fp8 grid, held in f32 (the paper's simulation: exact fp8 values,
wider arithmetic).
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


def quantize_columnwise(x: torch.Tensor):
    """Column-wise int8 (SwitchBackQ / LLM.int8 weights, and LLM.int8's
    weight-gradient operands): one scale per column of the last two dims."""
    state = _absmax(x, dim=-2)
    q = torch.round(x.float() * div(INT8_QMAX, state)).to(torch.int8)
    return q, state


def quantize_tensorwise(x: torch.Tensor):
    """Tensor-wise int8, Eq. (2): one scale for the whole tensor."""
    state = _absmax(x)
    q = torch.round(x.float() * div(INT8_QMAX, state)).to(torch.int8)
    return q, state


def dequantize_rowwise(q: torch.Tensor, state: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """q * (state / 127), the division tensor by tensor, then rounded once
    to ``dtype`` (SwitchBackM's backward, Alg. 3)."""
    return (q.float() * div(state, INT8_QMAX)).to(dtype)


def dequantize_tensorwise(q: torch.Tensor, state: torch.Tensor,
                          dtype=torch.float32) -> torch.Tensor:
    return (q.float() * div(state, INT8_QMAX)).to(dtype)


# ---------------------------------------------------------------------------
# fp8 "exact value" quantizers (paper §2.2.1, float8 paragraph)
# ---------------------------------------------------------------------------

FP8_DTYPES = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
FP8_MAX = {"e4m3": 448.0, "e5m2": 57344.0}
_FP8_MAN = {"e4m3": 3, "e5m2": 2}
_FP8_BIAS = {"e4m3": 7, "e5m2": 15}


def fp8_grid_round(x: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    """Round f32 values onto the fp8 grid in f32, round half to even, with
    the JAX package's bit trick: add half an ulp of the fp8 mantissa (less
    one, plus the kept lsb) to the magnitude's bits and clear the dropped
    bits; in the fp8-subnormal range round to the fixed step
    2^(1 - bias - man). The result is exactly representable, so the cast
    to the fp8 dtype that may follow is exact; a direct f32 -> fp8 cast is
    not used for the rounding itself (the reference rounds in f32 on
    purpose). The magnitude's bits stay below 2^31 after the clip, so
    int32 views serve for the reference's uint32 ones."""
    man, bias, fmax = _FP8_MAN[fmt], _FP8_BIAS[fmt], FP8_MAX[fmt]
    xf = x.float().clamp(-fmax, fmax)
    bits = xf.view(torch.int32)
    sign = bits & -(1 << 31)                      # 0x80000000
    mag = bits & 0x7FFFFFFF
    shift = 23 - man
    lsb = (mag >> shift) & 1
    magr = (mag + ((1 << (shift - 1)) - 1) + lsb) & -(1 << shift)
    pre = (sign | magr).view(torch.float32)
    sub_step = 2.0 ** (1 - bias - man)            # a power of two: exact
    sub = torch.round(xf / sub_step) * sub_step
    out = torch.where(xf.abs() < 2.0 ** (1 - bias), sub, pre)
    return out.clamp(-fmax, fmax)


def fp8_cast(x: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    """x rounded to the nearest fp8 value and widened back to f32,
    saturating at the format's max (no Inf/NaN)."""
    return fp8_grid_round(x, fmt).to(FP8_DTYPES[fmt]).float()


def quantize_tensorwise_fp8(x: torch.Tensor, fmt: str = "e4m3"):
    """Tensor-wise fp8: state = absmax (a scalar), values =
    fp8_cast(x / absmax) in [-1, 1]."""
    state = _absmax(x)
    return fp8_cast(x.float() / state, fmt), state


def quantize_rowwise_fp8(x: torch.Tensor, fmt: str = "e4m3"):
    """Row-wise fp8: one absmax per row of the last dim, state (..., 1)."""
    state = _absmax(x, dim=-1)
    return fp8_cast(x.float() / state, fmt), state
