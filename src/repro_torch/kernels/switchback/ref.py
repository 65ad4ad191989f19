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


def tensor_quantize(x: torch.Tensor):
    """x (R, C) -> (q int8 (R, C), state f32 (1, 1))."""
    q, state = Q.quantize_tensorwise(x)
    return q, state.reshape(1, 1)


def int8_matmul_dequant(x_q: torch.Tensor, w_q: torch.Tensor,
                        row_scale: torch.Tensor, *,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = f32(x_q . w_q) * row_scale, rounded to ``out_dtype``."""
    acc = (x_q.double() @ w_q.double()).float()
    return (acc * row_scale).to(out_dtype)


def int8_matmul_dequant_t(x_q: torch.Tensor, w_q: torch.Tensor,
                          row_scale: torch.Tensor, *,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """The ``transpose_w`` form: w_q (M, K), y = f32(x_q . w_q^T) * row_scale."""
    acc = (x_q.double() @ w_q.double().t()).float()
    return (acc * row_scale).to(out_dtype)


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
