"""SwitchBack: a linear layer for int8 and fp8 quantized training
(paper §2.2).

The PyTorch counterpart of ``repro/core/switchback.py``, on the JAX
package's kernel path (``make_switchback_matmul`` with a Pallas backend).
Three matmuls:

    forward:     Y = X W       int8 or fp8
    input grad:  Ẋ = Ẏ Wᵀ      int8 or fp8, contracted over W's second dim
    weight grad: Ẇ = Xᵀ Ẏ      16-bit inputs, f32 accumulation (the
                               "switch back": its inner dim is batch*seq),
                               or int8 / fp8 for the baselines

int8 variants:

* ``switchback``   (Alg. 1): row-wise X and Ẏ, tensor-wise W (Eq. 3);
  the forward fuses the X quantize when K <= 2048, the dgrad the Ẏ
  quantize when the output width is <= 2048; residuals (x, w_q, s_w).
* ``switchback_m`` (Alg. 3): the same quantizers, always two-step
  (row-quantize, then the int8 matmul); it saves only the int8 X with its
  state and dequantizes X to bf16 in the backward.
* ``switchback_q`` (Alg. 4): row-wise X, column-wise W (Eq. 4), the
  rank-1 ``row ⊗ col`` epilogue; the dgrad row-quantizes Ẏ and W (per
  input unit n) and contracts with the transposed colscale matmul. It
  re-quantizes W in the backward from the saved compute-dtype W.
* ``llm_int8``: ``switchback_q`` with an int8 weight gradient too
  (``wgrad_int8``), the paper's failing baseline.

The caller forms ``row_scale = s_x / 127²`` (``Q.div``) and passes the
weight's column state as ``col_scale``: the JAX kernel path's order,
``(s_x / 127²) * s_w``. (The JAX package's XLA path multiplies
``s_x * (s_w / 127²)`` instead, one rounding apart.)

fp8 variants (formats ``fwd_fmt`` for X and W, ``bwd_fmt`` for Ẏ; E4M3
and E5M2 by default; scales Scalify-style, ``q = fp8(x / s)``):

* ``fp8_sim``: the paper's fp8 baseline, simulated: X, W and Ẏ
  tensor-wise fp8 values held in f32 in all three matmuls, which are f32
  products (Ẇ from the fp8 X and Ẏ, not ``wgrad_16bit``).
* ``fp8_switchback``: the simulation with SwitchBack's quantizers:
  row-wise X and Ẏ, tensor-wise W, ``wgrad_16bit``.
* ``fp8``: real fp8 execution through the fp8 kernels: row-wise X,
  tensor-wise W, y = (x_q . w_q) * (s_x * s_w); the dgrad row-quantizes Ẏ
  and contracts with the forward's fp8 W over its second dim;
  ``wgrad_16bit``.
* ``fp8_mixed``: ``fp8`` with dynamic block-level bf16 fallback: X and Ẏ
  quantized in (block_rows x block_cols) tiles, tiles whose absmax exceeds
  ``fallback_ratio`` x the median run in bf16 against the dequantized W.

The two simulated variants are plain products, as the JAX package leaves
them to ``dot_general`` (on the card they need TF32 off).

``SwitchBackMatmul`` is the custom VJP as a ``torch.autograd.Function``.
It takes the weight as the layer hands it over and casts it to the
compute dtype inside ``forward`` (a no-op when the layer's ``use_weight``
already cast it, as the model's layers do); the weight gradient it
returns is f32, and torch casts it to the dtype of the weight it was
given.

W is stored (n_in, m_out), as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels.fp8_matmul import ops as F8OPS
from repro_torch.kernels.switchback import ops as KOPS

VARIANTS = ("switchback", "switchback_m", "switchback_q", "llm_int8",
            "fp8_sim", "fp8_switchback", "fp8", "fp8_mixed")


class FP8Config(NamedTuple):
    """The fp8 variants' knobs (``make_switchback_matmul``'s): formats of
    the forward operands and of the output gradient; ``fp8_mixed``'s tile
    over X / Ẏ and its fallback ratio."""
    fwd_fmt: str = "e4m3"
    bwd_fmt: str = "e5m2"
    block_rows: int = 128
    block_cols: int = 128
    fallback_ratio: float = 8.0


FP8_DEFAULT = FP8Config()

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


def _int8_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """aᵀ b for int8 a (R, n) and b (R, m), exact in int32: the contraction
    over the batch·seq rows of LLM.int8's weight gradient. The JAX package
    leaves it to XLA's dot_general, so this is a library product too: on
    the card ``torch._int_mm`` (which wants more than 16 output rows and
    multiples of 8 elsewhere: the zero rows and columns it pads with add
    nothing to the sum), on the CPU a float64 product (exact while
    |sum| < 2^53, i.e. for fewer than 5e11 rows)."""
    R, n = a.shape
    m = b.shape[1]
    if not a.is_cuda:
        return (a.double().t() @ b.double()).to(torch.int32)
    pr, pn, pm = (-R) % 8, max(0, 17 - n), (-m) % 8
    at = torch.nn.functional.pad(a, (0, pn, 0, pr)).t().contiguous()
    bp = torch.nn.functional.pad(b, (0, pm, 0, pr))
    return torch._int_mm(at, bp)[:n, :m]


def wgrad_int8(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """LLM.int8()'s weight gradient (``_wgrad_int8``): X and Ẏ quantized
    per column (per n and per m), Ẇ[n, m] = Σ_b X_q[b, n] Ẏ_q[b, m] in
    int32, dequantized by ``s_xᵀ * (s_g / 127²)``. The matmul SwitchBack
    refuses to quantize: its inner dim is batch·seq (App. C)."""
    x_q, s_x = Q.quantize_columnwise(x)            # (b, n), (1, n)
    g_q, s_g = Q.quantize_columnwise(g)            # (b, m), (1, m)
    acc = _int8_tn(x_q, g_q)                       # (n, m)
    return acc.float() * (s_x.t() * Q.div(s_g, _I2))


def _fp8_sim_dot(a_q, s_a, b_q, s_b, out_dtype=None):
    """(a_q . b_q) * (s_a * s_b) as an f32 product of the fp8-valued
    operands (the simulated variants; the JAX package's ``dot_general``),
    rounded to ``out_dtype`` when given."""
    y = torch.mm(a_q, b_q) * (s_a * s_b)
    return y if out_dtype is None else y.to(out_dtype)


def _fp8_forward(ctx, x, wc, variant, f: FP8Config):
    """The fp8 variants' forward; saves their residuals on ``ctx``."""
    if variant == "fp8_sim":
        x_q, s_x = Q.quantize_tensorwise_fp8(x, f.fwd_fmt)
        w_q, s_w = Q.quantize_tensorwise_fp8(wc, f.fwd_fmt)
        ctx.save_for_backward(x, wc)
        return _fp8_sim_dot(x_q, s_x, w_q, s_w, x.dtype)
    if variant == "fp8_switchback":
        x_q, s_x = Q.quantize_rowwise_fp8(x, f.fwd_fmt)
        w_q, s_w = Q.quantize_tensorwise_fp8(wc, f.fwd_fmt)
        ctx.save_for_backward(x, w_q, s_w)
        return _fp8_sim_dot(x_q, s_x, w_q, s_w, x.dtype)
    w_q, s_w = F8OPS.tensor_quantize(wc, f.fwd_fmt)              # (n, m), (1, 1)
    ctx.save_for_backward(x, w_q, s_w)                          # fp X + fp8 W
    if variant == "fp8":
        x_q, s_x = F8OPS.row_quantize(x, f.fwd_fmt)
        return F8OPS.fp8_matmul_dequant(x_q, w_q, s_x * s_w, out_dtype=x.dtype)
    return F8OPS.mixed(x, w_q, s_w, fmt=f.fwd_fmt, block_rows=f.block_rows,
                       block_cols=f.block_cols, fallback_ratio=f.fallback_ratio,
                       out_dtype=x.dtype)


def _fp8_backward(ctx, g, need_dx, need_dw):
    """The fp8 variants' (Ẋ, Ẇ): the dgrad in ``bwd_fmt`` against the
    forward's W; Ẇ from ``wgrad_16bit``, or for ``fp8_sim`` the f32
    product of the tensor-wise fp8 X and Ẏ."""
    variant, f = ctx.variant, ctx.fp8
    dx = dw = None
    if variant == "fp8_sim":
        x, wc = ctx.saved_tensors
        g_q, s_g = Q.quantize_tensorwise_fp8(g, f.bwd_fmt)
        if need_dx:
            w_q, s_w = Q.quantize_tensorwise_fp8(wc, f.fwd_fmt)
            dx = _fp8_sim_dot(g_q, s_g, w_q.t(), s_w, g.dtype)
        if need_dw:
            x_q, s_x = Q.quantize_tensorwise_fp8(x, f.fwd_fmt)
            dw = _fp8_sim_dot(x_q.t(), s_x, g_q, s_g)
        return dx, dw
    x, w_q, s_w = ctx.saved_tensors
    if need_dx:
        if variant == "fp8_switchback":
            g_q, s_g = Q.quantize_rowwise_fp8(g, f.bwd_fmt)
            dx = _fp8_sim_dot(g_q, s_g, w_q.t(), s_w, g.dtype)
        elif variant == "fp8":
            g_q, s_g = F8OPS.row_quantize(g, f.bwd_fmt)
            dx = F8OPS.fp8_matmul_dequant_t(g_q, w_q, s_g * s_w, out_dtype=g.dtype)
        else:                                                   # fp8_mixed
            dx = F8OPS.mixed(g, w_q, s_w, fmt=f.bwd_fmt, block_rows=f.block_rows,
                             block_cols=f.block_cols, fallback_ratio=f.fallback_ratio,
                             transpose_w=True, out_dtype=g.dtype)
    if need_dw:
        dw = wgrad_16bit(x, g)
    return dx, dw


class SwitchBackMatmul(torch.autograd.Function):
    """``f(x2d, w, compute_dtype, variant, fp8) -> y2d``: x2d (b, n) in the
    compute dtype, w (n, m) the weight as the layer hands it over, ``fp8``
    an ``FP8Config`` (read by the fp8 variants). Ẋ in x's dtype, Ẇ in f32
    (see the module docstring for the residuals each variant keeps)."""

    @staticmethod
    def forward(ctx, x, w, compute_dtype, variant, fp8=FP8_DEFAULT):
        ctx.variant, ctx.fp8 = variant, fp8
        wc = w.to(compute_dtype)
        if variant.startswith("fp8"):
            return _fp8_forward(ctx, x, wc, variant, fp8)
        if variant == "switchback":
            y, w_q, s_w = _kfwd_rowwise_tensorwise(x, wc)
            ctx.save_for_backward(x, w_q, s_w)
        elif variant == "switchback_m":
            x_q, s_x = KOPS.row_quantize(x)
            w_q, s_w = KOPS.tensor_quantize(wc)
            y = KOPS.int8_matmul_dequant(x_q, w_q, s_x * Q.div(s_w, _I2), out_dtype=x.dtype)
            ctx.save_for_backward(x_q, s_x, w_q, s_w)       # int8 residuals only
        else:                                               # switchback_q, llm_int8
            x_q, s_x = KOPS.row_quantize(x)
            w_q, s_w = KOPS.col_quantize(wc)                # (n, m), (1, m)
            y = KOPS.int8_matmul_dequant(x_q, w_q, Q.div(s_x, _I2), col_scale=s_w,
                                         out_dtype=x.dtype)
            ctx.save_for_backward(x, wc)                    # re-quantize W in bwd
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx = dw = None
        if ctx.variant.startswith("fp8"):
            return (*_fp8_backward(ctx, g, need_dx, need_dw), None, None, None)
        if ctx.variant in ("switchback", "switchback_m"):
            if ctx.variant == "switchback":
                x, w_q, s_w = ctx.saved_tensors
            else:
                x_q, s_x, w_q, s_w = ctx.saved_tensors
                x = Q.dequantize_rowwise(x_q, s_x, torch.bfloat16)   # Alg. 3
            if need_dx:
                dx = _kdgrad_tensorwise(g, w_q, s_w)
            if need_dw:
                dw = wgrad_16bit(x, g)
            return dx, dw, None, None, None
        x, wc = ctx.saved_tensors
        if need_dx:
            # the column state (1, m) of W sits on the dgrad's contracted
            # dim, so W is row-quantized along n instead (Alg. 4) and its
            # (n, 1) state becomes the dgrad's column scale
            g_q, s_g = KOPS.row_quantize(g)
            w_q_n, s_w_n = KOPS.row_quantize(wc)
            dx = KOPS.int8_matmul_dequant_t(g_q, w_q_n, Q.div(s_g, _I2),
                                            col_scale=s_w_n.reshape(1, -1), out_dtype=g.dtype)
        if need_dw:
            dw = (wgrad_int8 if ctx.variant == "llm_int8" else wgrad_16bit)(x, g)
        return dx, dw, None, None, None


def switchback_linear(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor | None = None, *,
                      variant: str = "switchback",
                      compute_dtype: torch.dtype | None = None,
                      fp8: FP8Config = FP8_DEFAULT) -> torch.Tensor:
    """SwitchBack linear on ``x`` (..., n) with ``w`` (n, m): leading dims
    flatten into rows (one row-wise scale per token) and are restored.
    ``w`` is cast to ``compute_dtype`` (default: x's dtype) inside the
    autograd function; Ẇ comes back in w's dtype. The output has x's
    dtype. ``fp8`` holds the fp8 variants' formats and tile knobs."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown SwitchBack variant {variant!r}; expected one of {VARIANTS}")
    n = x.shape[-1]
    lead = x.shape[:-1]
    y2 = SwitchBackMatmul.apply(x.reshape(-1, n).contiguous(), w,
                                compute_dtype or x.dtype, variant, fp8)
    y = y2.reshape(*lead, w.shape[-1])
    if b is not None:
        y = y + b.to(y.dtype)
    return y
