"""SwitchBack: a linear layer for int8 quantized training (paper §2.2).

The PyTorch counterpart of ``repro/core/switchback.py``, ``switchback``
variant (Alg. 1): row-wise int8 X and Ẏ, tensor-wise int8 W, three
matmuls:

    forward:     Y = X W       int8 (Eq. 3), fused quantize when K <= 2048
    input grad:  Ẋ = Ẏ Wᵀ      int8, reusing the forward's (w_q, s_w),
                               contracted over W's second dim
    weight grad: Ẇ = Xᵀ Ẏ      16-bit inputs, f32 accumulation (the
                               "switch back": its inner dim is batch*seq)

``SwitchBackMatmul`` is the JAX package's ``make_switchback_matmul``
custom VJP as a ``torch.autograd.Function``. It takes the f32 master
weight and casts it to the compute dtype inside ``forward``, so the f32
weight gradient it returns reaches the master unrounded: torch casts a
``Function``'s gradient to its input's dtype, and a bf16 input would round
it. The other seven variants (switchback_m / _q, llm_int8, the fp8
family) raise until their slices.

W is stored (n_in, m_out), as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels.switchback import ops as KOPS

VARIANTS = ("switchback",)

_I2 = Q.INT8_QMAX * Q.INT8_QMAX


def _kfwd_rowwise_tensorwise(x: torch.Tensor, w: torch.Tensor):
    """Eq. (3) forward: the fused quantize+matmul kernel when the
    contraction K fits ``FUSED_MAX_CONTRACT``, else row-quantize then the
    tiled int8 matmul (same math). Returns (y in x's dtype, w_q, s_w)."""
    w_q, s_w = KOPS.tensor_quantize(w)                       # (n, m), (1, 1)
    if x.shape[1] <= KOPS.FUSED_MAX_CONTRACT:
        y = KOPS.fused_switchback_fwd(x, w_q, s_w)
    else:
        x_q, s_x = KOPS.row_quantize(x)
        y = KOPS.int8_matmul_dequant(x_q, w_q, s_x * Q.div(s_w, _I2),
                                     out_dtype=x.dtype)
    return y, w_q, s_w


def _kdgrad_tensorwise(g: torch.Tensor, w_q: torch.Tensor,
                       s_w: torch.Tensor) -> torch.Tensor:
    """Ẋ = Ẏ Wᵀ: the fused Ẏ-quantize dgrad kernel when the contraction
    (the layer's output width) fits ``FUSED_MAX_CONTRACT``, else
    row-quantize then the transposed int8 matmul. ``w_q`` is the forward's
    int8 W, contracted over its second dim. The output has g's dtype."""
    if g.shape[1] <= KOPS.FUSED_MAX_CONTRACT:
        return KOPS.fused_switchback_dgrad(g, w_q, s_w)
    g_q, s_g = KOPS.row_quantize(g)
    return KOPS.int8_matmul_dequant_t(g_q, w_q, s_g * Q.div(s_w, _I2),
                                      out_dtype=g.dtype)


def wgrad_16bit(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Ẇ = Xᵀ Ẏ from bf16 inputs with f32 accumulation, returned in f32
    (``_wgrad_16bit``; the JAX package leaves it to XLA's dot_general, so
    this is a library product, not a kernel). On the card one bf16 GEMM
    with an f32 output; on the CPU, which has no such GEMM, an f32 product
    of the bf16-rounded inputs (their products are exact in f32)."""
    xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
    if xb.is_cuda:
        return torch.mm(xb.t(), gb, out_dtype=torch.float32)
    return xb.float().t() @ gb.float()


class SwitchBackMatmul(torch.autograd.Function):
    """``f(x2d, w, compute_dtype) -> y2d``: x2d (b, n) in the compute
    dtype, w (n, m) the master weight. Residuals (x, w_q, s_w), as the
    JAX package saves them; Ẋ in x's dtype, Ẇ in f32."""

    @staticmethod
    def forward(ctx, x, w, compute_dtype):
        y, w_q, s_w = _kfwd_rowwise_tensorwise(x, w.to(compute_dtype))
        ctx.save_for_backward(x, w_q, s_w)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w_q, s_w = ctx.saved_tensors
        g = g.contiguous()
        dx = _kdgrad_tensorwise(g, w_q, s_w) if ctx.needs_input_grad[0] else None
        dw = wgrad_16bit(x, g) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def switchback_linear(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor | None = None, *,
                      variant: str = "switchback",
                      compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """SwitchBack linear on ``x`` (..., n) with ``w`` (n, m): leading dims
    flatten into rows (one row-wise scale per token) and are restored.
    ``w`` is cast to ``compute_dtype`` (default: x's dtype) inside the
    autograd function, so a master weight keeps an f32 gradient. The
    output has x's dtype."""
    if variant not in VARIANTS:
        raise NotImplementedError(
            f"SwitchBack variant {variant!r} is not ported yet: the port runs "
            f"{VARIANTS}; the other variants follow with their slices "
            "(ROADMAP.md Queue 1)")
    n = x.shape[-1]
    lead = x.shape[:-1]
    y2 = SwitchBackMatmul.apply(x.reshape(-1, n).contiguous(), w,
                                compute_dtype or x.dtype)
    y = y2.reshape(*lead, w.shape[-1])
    if b is not None:
        y = y + b.to(y.dtype)
    return y
