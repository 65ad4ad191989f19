"""The paper's quantizers: int8 Eq. (1) row-wise, Eq. (2) tensor-wise and
the column-wise weight state of Eq. (4), the int8 products with fused
dequantization of Eq. (3) and Eq. (4), row-wise stochastic rounding (an
ablation, not on the paper's path); and the fp8 "exact value" quantizers
of §2.2.1 (E4M3 and E5M2) with their simulated product.

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
# int8 matmuls with fused dequantization (paper Eq. 3 / Eq. 4)
# ---------------------------------------------------------------------------

def _int8_acc(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """x_q (..., b, n) . w_q (m, n)ᵀ summed exactly: float64 holds every
    int32 sum of int8 products (|acc| <= 127² n < 2^53), and torch has no
    integer matmul on CUDA. Rounding it to f32 is the one rounding of the
    reference's int32 -> f32 conversion."""
    return x_q.double() @ w_q.double().t()


def int8_matmul_dequant_rowwise_tensorwise(x_q: torch.Tensor, w_q: torch.Tensor,
                                           state_x: torch.Tensor, state_w: torch.Tensor,
                                           out_dtype=torch.float32) -> torch.Tensor:
    """Eq. (3): f32(Q_row(X) Q_tensor(W)ᵀ) * (state_x * (state_w / 127²)),
    the scale rounded as the reference rounds it. ``x_q`` (..., b, n) int8
    with row state (..., b, 1); ``w_q`` (m, n) int8 with a scalar state.
    Returns (..., b, m). The CUDA ``int8_matmul_dequant_t`` takes the same
    scale and rounds its epilogue the same way (``core/analysis.py`` runs
    it on the card)."""
    scale = state_x * div(state_w.reshape(()), INT8_QMAX * INT8_QMAX)
    return (_int8_acc(x_q, w_q).float() * scale).to(out_dtype)


def int8_matmul_dequant_rowwise_rowwise(x_q: torch.Tensor, w_q: torch.Tensor,
                                        state_x: torch.Tensor, state_w: torch.Tensor,
                                        out_dtype=torch.float32) -> torch.Tensor:
    """Eq. (4) (SwitchBackQ / LLM.int8() style): both operands row-wise,
    ``w_q`` (m, n) with state (m, 1); the scale is the outer product
    state_x * (state_wᵀ / 127²), rounded as the reference rounds it."""
    scale = state_x * div(state_w.transpose(-1, -2), INT8_QMAX * INT8_QMAX)
    return (_int8_acc(x_q, w_q).float() * scale).to(out_dtype)


# ---------------------------------------------------------------------------
# stochastic rounding (an ablation for int8 weight-gradient experiments)
# ---------------------------------------------------------------------------

def stochastic_codes(x: torch.Tensor, state: torch.Tensor,
                     uniforms: torch.Tensor) -> torch.Tensor:
    """The reference's formula given its uniforms: with s = x * (127 /
    state), q = floor(s) + (u < s - floor(s)), as int8."""
    scaled = x.float() * div(INT8_QMAX, state)
    floor = torch.floor(scaled)
    return (floor + (uniforms < scaled - floor).float()).to(torch.int8)


def quantize_rowwise_stochastic(x: torch.Tensor, generator: torch.Generator):
    """Row-wise int8 with stochastic rounding (unbiased noise; not on the
    paper's path). The uniforms come from ``generator`` (the reference
    draws them from a threefry key, which torch cannot replay), so only the
    draw differs: ``stochastic_codes`` is the reference's formula."""
    state = _absmax(x, dim=-1)
    u = torch.rand(x.shape, generator=generator, dtype=torch.float32, device=x.device)
    return stochastic_codes(x, state, u), state


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


def fp8_matmul_dequant(x_q: torch.Tensor, w_q: torch.Tensor, state_x: torch.Tensor,
                       state_w: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """The simulated fp8 product: operands hold exact fp8 values (in f32),
    an f32 product, then ``acc * (state_x * state_w)`` with a row or
    scalar state_x and a scalar or (m, 1) row state_w (transposed)."""
    acc = x_q.float() @ w_q.float().t()
    sw = state_w if state_w.dim() == 0 else state_w.transpose(-1, -2)
    return (acc * (state_x * sw)).to(out_dtype)
