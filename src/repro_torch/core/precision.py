"""Precision policy: how every linear layer computes.

The PyTorch counterpart of ``repro/core/precision.py``. Every linear goes
through ``quant_linear``; ``QuantPolicy.mode`` picks the plain 16-bit
product (``bf16``, the paper's baseline) or the SwitchBack int8 linear
(``int8_switchback``, alias ``int8``). Both are differentiable, and both
take the f32 master weight and cast it inside their autograd function, so
the weight gradient reaches the master in f32, unrounded (a cast outside
would round it to the compute dtype on the way back). The JAX package's
other modes raise ``NotImplementedError`` until their slice is ported.

There is no kernel-backend field: the SwitchBack ops dispatch on the
device of their tensors (plain PyTorch on the CPU, CUDA kernels on the
card).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import switchback as SB

# every mode of the JAX package, and the ones this port runs so far
MODES = (
    "bf16", "fp16", "fp32",
    "int8", "int8_switchback", "int8_switchback_m", "int8_switchback_q",
    "int8_llm",
    "fp8_sim", "fp8_switchback", "fp8", "fp8_mixed",
)
PORTED_MODES = ("bf16", "int8", "int8_switchback")

_SB_VARIANT = {
    "int8": "switchback",            # alias: the knob spans int8|fp8|mixed
    "int8_switchback": "switchback",
}


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Precision policy for linear layers + compute dtypes.

    mode: one of ``PORTED_MODES``. The quantized mode applies to every
        transformer linear (QKV/out projections, MLP); embeddings, norms
        and the tied lm head stay in ``compute_dtype``.
    compute_dtype: activation dtype between quantized ops.

    The JAX policy's ``param_dtype`` is left out: nothing reads it there
    either, and the port's master weights take ``ParamSpec.dtype`` (f32).
    """
    mode: str = "bf16"
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.mode not in PORTED_MODES:
            raise NotImplementedError(
                f"quant mode {self.mode!r} is not ported yet: this slice "
                f"serves {PORTED_MODES}; the other int8 variants and the fp8 "
                "modes come with later slices (ROADMAP.md Queue 2)")

    @property
    def is_quantized(self) -> bool:
        return self.mode in _SB_VARIANT


BF16 = QuantPolicy("bf16")


class Dense16Matmul(torch.autograd.Function):
    """The plain product of the 16-bit modes, ``f(x2d, w, cd) -> y2d``:
    x and the master w cast to ``cd``, f32 accumulation, y rounded to
    ``cd``; Ẋ = Ẏ Wᵀ in ``cd``, Ẇ = Xᵀ Ẏ accumulated and returned in f32."""

    @staticmethod
    def forward(ctx, x, w, cd):
        xc, wc = x.to(cd), w.to(cd)
        ctx.save_for_backward(xc, wc)
        return xc @ wc

    @staticmethod
    def backward(ctx, g):
        xc, wc = ctx.saved_tensors
        g = g.to(xc.dtype)
        dx = g @ wc.t() if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = (SB.wgrad_16bit(xc, g) if xc.dtype == torch.bfloat16
                  else xc.float().t() @ g.float())
        return dx, dw, None


def quant_linear(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor | None = None, *,
                 policy: QuantPolicy = BF16) -> torch.Tensor:
    """The single entry point for every linear layer.

    ``x``: (..., n) activations; ``w``: (n, m) the f32 master weight (the
    layers hand it over uncast). The JAX package casts ``w`` to the
    compute dtype and, for the int8 modes, widens it to f32 before
    quantizing; the widening is exact, so the kernel quantizes the
    compute-dtype weight directly and sees the same values.
    """
    cd = policy.compute_dtype
    n = x.shape[-1]
    lead = x.shape[:-1]
    if policy.is_quantized:
        return SB.switchback_linear(x.to(cd), w, b,
                                    variant=_SB_VARIANT[policy.mode],
                                    compute_dtype=cd)
    y = Dense16Matmul.apply(x.reshape(-1, n), w, cd).reshape(*lead, w.shape[-1])
    if b is not None:
        y = y + b.to(y.dtype)
    return y
