"""Quantization-noise variance analysis (paper Appendix C); the port of
``repro/core/analysis.py``.

For an inner product ⟨û, v̂⟩ of quantized length-k vectors with elementwise
quantization-noise variance σ_q², the paper derives (Eq. 12-14):

    Var(⟨û, v̂⟩) = Var(⟨u, v⟩) + k · σ_q² (σ_u² + σ_v² + σ_q²)

so the quantization variance grows linearly in the inner dimension k. That
is SwitchBack's reason to keep the weight gradient in 16 bits: its k is
batch × sequence (about 65,536 for CLIP ViT-H, App. C.3), while the forward
and input-gradient products contract over at most 4 × the width.

``empirical_matmul_quant_error`` measures the Eq. 3 product (row-wise x,
tensor-wise W) through the SwitchBack kernel wrappers: on CUDA tensors the
port's ``row_quantize``, ``tensor_quantize`` and ``int8_matmul_dequant_t``
kernels, on CPU tensors their plain versions (``core/quantization.py``'s
arithmetic, bit for bit).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels.switchback import ops as KOPS


def predicted_quant_variance(k: int, sigma_u: float, sigma_v: float,
                             sigma_q: float) -> float:
    """The paper's Eq. (14) excess variance term: k·σ_q²(σ_u²+σ_v²+σ_q²)."""
    return k * sigma_q ** 2 * (sigma_u ** 2 + sigma_v ** 2 + sigma_q ** 2)


def _std(x: torch.Tensor) -> torch.Tensor:
    """The population standard deviation, as ``jnp.std`` takes it."""
    return torch.std(x, correction=0)


def rowwise_int8_noise_sigma(x: torch.Tensor) -> torch.Tensor:
    """Empirical σ_q of row-wise int8 quantization of ``x``: the std of
    dequant(quant(x)) - x. For uniform rounding noise with step
    Δ = absmax/127 it is about Δ/sqrt(12)."""
    q, s = Q.quantize_rowwise(x)
    return _std(Q.dequantize_rowwise(q, s) - x.float())


def eq3_product(x: torch.Tensor, w: torch.Tensor):
    """The Eq. 3 product of f32 x (b, k) and w (m, k) through the kernel
    wrappers: (x_q, s_x, w_q, s_w, approx (b, m) f32)."""
    x_q, s_x = KOPS.row_quantize(x)
    w_q, s_w = KOPS.tensor_quantize(w)
    scale = s_x * Q.div(s_w.reshape(()), Q.INT8_QMAX * Q.INT8_QMAX)
    return x_q, s_x, w_q, s_w, KOPS.int8_matmul_dequant_t(x_q, w_q, scale,
                                                         out_dtype=torch.float32)


def empirical_matmul_quant_error(generator: torch.Generator, b: int, k: int, m: int,
                                 n_trials: int = 4) -> Tuple[float, float]:
    """Var(quantized product - exact product) per output element of a
    row-wise × tensor-wise int8 product (Eq. 3) with iid N(0, 1) operands,
    against the App. C prediction: (measured, predicted). The operands are
    drawn from ``generator`` on its device (the reference draws them from a
    threefry key); the exact product is f32, as the reference's."""
    dev = generator.device
    errs, sigma_qs = [], []
    for _ in range(n_trials):
        x = torch.randn((b, k), generator=generator, device=dev)
        w = torch.randn((m, k), generator=generator, device=dev)    # (m, n) convention
        exact = x @ w.t()
        x_q, s_x, w_q, s_w, approx = eq3_product(x, w)
        errs.append(torch.var(approx - exact, correction=0))
        # noise sigma of each operand
        sq_x = _std(Q.dequantize_rowwise(x_q, s_x) - x)
        sq_w = _std(Q.dequantize_tensorwise(w_q, s_w) - w)
        sigma_qs.append(torch.sqrt(sq_x * sq_w))   # the geometric mean of the two
    measured = float(torch.mean(torch.stack(errs)))
    sigma_q = float(torch.mean(torch.stack(sigma_qs)))
    return measured, predicted_quant_variance(k, 1.0, 1.0, sigma_q)
