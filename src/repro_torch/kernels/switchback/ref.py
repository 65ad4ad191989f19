"""Plain PyTorch versions of the SwitchBack kernels.

They repeat the kernels' arithmetic operation by operation (the JAX
package's ``repro/kernels/switchback/ref.py``; the quantizers are
``core/quantization.py``'s), so a kernel and its plain version agree bit
for bit. ``ops.py`` sends CPU tensors here; on the card
``chip_smoke.py`` holds each CUDA kernel against these on the same inputs.

The int8 product runs in float64: torch has no integer matmul on CUDA, and
float64 is exact here (|acc| <= 127^2 * K < 2^53 for any K below 5e8).
Rounding the exact float64 sum to f32 is the same single rounding as the
int32 -> f32 conversion the kernels do.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantization as Q

QMAX = Q.INT8_QMAX
div = Q.div


def row_quantize(x: torch.Tensor):
    """x (B, K) -> (q int8 (B, K), state f32 (B, 1))."""
    return Q.quantize_rowwise(x)


def col_quantize(x: torch.Tensor):
    """x (R, C) -> (q int8 (R, C), state f32 (1, C)): one scale per column."""
    return Q.quantize_columnwise(x)


def tensor_quantize(x: torch.Tensor):
    """x (R, C) -> (q int8 (R, C), state f32 (1, 1))."""
    q, state = Q.quantize_tensorwise(x)
    return q, state.reshape(1, 1)


def _dequant(acc: torch.Tensor, row_scale, col_scale, out_dtype) -> torch.Tensor:
    """f32(acc) * row_scale, or with a column scale f32(acc) * (row_scale *
    col_scale): the rank-1 product rounded once, then the multiply."""
    scale = row_scale if col_scale is None else row_scale * col_scale
    return (acc.float() * scale).to(out_dtype)


def int8_matmul_dequant(x_q: torch.Tensor, w_q: torch.Tensor,
                        row_scale: torch.Tensor, *, col_scale=None,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = f32(x_q . w_q) * row_scale [* col_scale], rounded to ``out_dtype``."""
    return _dequant(x_q.double() @ w_q.double(), row_scale, col_scale, out_dtype)


def int8_matmul_dequant_t(x_q: torch.Tensor, w_q: torch.Tensor,
                          row_scale: torch.Tensor, *, col_scale=None,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """The ``transpose_w`` form: w_q (M, K), y = f32(x_q . w_q^T) *
    row_scale [* col_scale]."""
    return _dequant(x_q.double() @ w_q.double().t(), row_scale, col_scale, out_dtype)


def fused_switchback_fwd(x: torch.Tensor, w_q: torch.Tensor,
                         s_w: torch.Tensor) -> torch.Tensor:
    """Row-quantize x, int8 product, dequantize; the output has x's dtype."""
    x_q, s_x = row_quantize(x)
    scale = s_x * div(s_w.reshape(()), QMAX * QMAX)
    return int8_matmul_dequant(x_q, w_q, scale, out_dtype=x.dtype)


def fused_switchback_dgrad(g: torch.Tensor, w_q: torch.Tensor,
                           s_w: torch.Tensor) -> torch.Tensor:
    """Input gradient: row-quantize g (B, M), contract with the forward's
    w_q (N, M) over M, dequantize; the output has g's dtype."""
    g_q, s_g = row_quantize(g)
    scale = s_g * div(s_w.reshape(()), QMAX * QMAX)
    return int8_matmul_dequant_t(g_q, w_q, scale, out_dtype=g.dtype)


# The expert-batched forms: the 2-D plain versions above, one expert at a
# time (``jax.vmap`` of the TPU kernels over the leading expert dim). Each
# expert's arithmetic is its 2-D call's, so a batched kernel agrees bit for
# bit with these and with a loop of the 2-D kernels.

def tensor_quantize_batched(x: torch.Tensor):
    """x (E, R, C) -> (q int8 (E, R, C), state f32 (E, 1, 1)): one absmax
    per expert."""
    qs, ss = zip(*(tensor_quantize(xe) for xe in x))
    return torch.stack(qs), torch.stack(ss)


def fused_switchback_fwd_batched(x: torch.Tensor, w_q: torch.Tensor,
                                 s_w: torch.Tensor) -> torch.Tensor:
    """x (E, B, K), w_q (E, K, M) int8, s_w (E, 1, 1) -> (E, B, M) in x's dtype."""
    return torch.stack([fused_switchback_fwd(xe, we, se) for xe, we, se in zip(x, w_q, s_w)])


def fused_switchback_dgrad_batched(g: torch.Tensor, w_q: torch.Tensor,
                                   s_w: torch.Tensor) -> torch.Tensor:
    """g (E, B, M), w_q (E, N, M) int8, s_w (E, 1, 1) -> (E, B, N) in g's dtype."""
    return torch.stack([fused_switchback_dgrad(ge, we, se) for ge, we, se in zip(g, w_q, s_w)])


def wgrad_bf16(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Ẇ = xᵀ g: x (B, K) and g (B, M) rounded to bf16, (K, M) in f32, each
    output the sum of its B products in order b = 0, 1, ..., B-1. A bf16
    product is exact in f32, so each step rounds once. The CUDA kernel sums
    on bf16 wgmma in windows of B (``WGRAD_WINDOW``): it agrees with this
    to ``wgrad_bound``, bit for bit where every sum is exact."""
    xf = x.to(torch.bfloat16).float()
    gf = g.to(torch.bfloat16).float()
    acc = torch.zeros((xf.shape[1], gf.shape[1]), dtype=torch.float32, device=x.device)
    for b in range(xf.shape[0]):
        acc.addcmul_(xf[b, :, None], gf[b, None, :])
    return acc


# How far the CUDA wgrad_bf16 (bf16 wgmma) may lie from ``wgrad_bf16``.
# The kernel chains WGRAD_WINDOW / 16 m64n128k16 steps over each window of
# WGRAD_WINDOW rows of B into a fresh fragment and adds the windows in B
# order into an f32 accumulator. A bf16 step (kernels/fp8_matmul/
# wgmma_model.py, fitted to an H100 and checked by chip_smoke.py's probe)
# truncates each addend (its 16 products and, after a window's first step,
# the fragment) to 2^(E - 25), E the largest of their exponents, at most the
# window's sum of magnitudes, and its sum to 24 significant bits: each of
# those WGRAD_ADDENDS truncations loses less than 2^-23 of the window's
# sum of |products|. Each window's f32 add rounds once (2^-24 of the running
# sum), and so does each of the plain version's B - 1 in-order adds. So per
# output |kernel - plain| <= (WGRAD_ADDENDS + (n_windows - 1) / 2
# + (B - 1) / 2) 2^-23 (|x|ᵀ|g|) + 1 ulp of f32 (products below f32's
# normal range), |.| of a bf16 subnormal taken as 2^-126, the magnitude a
# step aligns it by.
WGRAD_WINDOW = 64
WGRAD_STEP = 16
WGRAD_ADDENDS = WGRAD_WINDOW + (WGRAD_WINDOW // WGRAD_STEP - 1) + WGRAD_WINDOW // WGRAD_STEP
_BF16_MIN_NORMAL = 2.0 ** -126


def _mag16(t: torch.Tensor) -> torch.Tensor:
    """|bf16(t)| in float64, a nonzero subnormal raised to 2^-126."""
    a = t.to(torch.bfloat16).double().abs()
    return torch.where((a > 0) & (a < _BF16_MIN_NORMAL), _BF16_MIN_NORMAL, a)


def wgrad_bound(y_plain: torch.Tensor, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per output (float64, (K, M)), the most the CUDA ``wgrad_bf16`` may
    differ from ``y_plain``, the plain version's output on the same inputs:
    c 2^-23 (|x|ᵀ|g|) + 1 ulp of f32, c = WGRAD_ADDENDS + (n_windows - 1)
    / 2 + (B - 1) / 2."""
    B = x.shape[0]
    c = WGRAD_ADDENDS + (max(-(-B // WGRAD_WINDOW) - 1, 0) + max(B - 1, 0)) / 2
    terms = c * 2.0 ** -23 * (_mag16(x).t() @ _mag16(g))
    a = (y_plain.double().abs() + terms).clamp_min(torch.finfo(torch.float32).tiny)
    return terms + torch.ldexp(torch.ones_like(a), torch.frexp(a).exponent - 24)
