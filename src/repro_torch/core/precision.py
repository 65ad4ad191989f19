"""Precision policy: how every linear layer computes.

The PyTorch counterpart of ``repro/core/precision.py``. Every linear goes
through ``quant_linear``; ``QuantPolicy.mode`` picks the plain 16-bit
product (``bf16``, the paper's baseline), a SwitchBack int8 linear
(``int8_switchback``, alias ``int8``, Alg. 1; ``int8_switchback_m``,
Alg. 3; ``int8_switchback_q``, Alg. 4; ``int8_llm``, the LLM.int8()
baseline) or an fp8 one: ``fp8_sim`` (the paper's simulated fp8
baseline), ``fp8_switchback`` (its simulation with SwitchBack's
quantizers), ``fp8`` (real fp8 kernels, E4M3 forward, E5M2 gradient) and
``fp8_mixed`` (``fp8`` with dynamic block-level bf16 fallback). All are
differentiable. Each autograd function casts the
weight to the compute dtype itself and returns its gradient in f32;
torch casts that gradient to the dtype of the weight it was handed. The
model's layers hand over the weight already cast to the compute dtype
(``use_weight(..., dtype)``, as the JAX layers do), so the weight
gradient is rounded through bf16 on its way back to the f32 master,
exactly as ``jax.grad`` rounds it in the JAX package; called directly
with an f32 weight, ``quant_linear`` returns an unrounded f32 gradient,
as the JAX ``quant_linear`` does. ``fp16`` and ``fp32`` raise
``NotImplementedError``: no slice has needed them yet.

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
PORTED_MODES = ("bf16", "int8", "int8_switchback", "int8_switchback_m",
                "int8_switchback_q", "int8_llm",
                "fp8_sim", "fp8_switchback", "fp8", "fp8_mixed")

_SB_VARIANT = {
    "int8": "switchback",            # alias: the knob spans int8|fp8|mixed
    "int8_switchback": "switchback",
    "int8_switchback_m": "switchback_m",
    "int8_switchback_q": "switchback_q",
    "int8_llm": "llm_int8",
    "fp8_sim": "fp8_sim",
    "fp8_switchback": "fp8_switchback",
    "fp8": "fp8",                    # real fp8 kernels (E4M3 fwd / E5M2 bwd)
    "fp8_mixed": "fp8_mixed",        # fp8 + dynamic block-level bf16 fallback
}


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Precision policy for linear layers + compute dtypes.

    mode: one of ``PORTED_MODES``. The quantized mode applies to every
        transformer linear (QKV/out projections, MLP); embeddings, norms
        and the tied lm head stay in ``compute_dtype``.
    compute_dtype: activation dtype between quantized ops.
    fwd_fmt / bwd_fmt: fp8 formats of the forward operands / gradients.
    fp8_block_rows / fp8_block_cols / fp8_fallback_ratio (``fp8_mixed``
        only): the blockwise-quantization tile over X and Ẏ (one scale and
        one fallback bit per tile) and the absmax-vs-median ratio above
        which a tile's matmul runs in bf16.

    The JAX policy's ``param_dtype`` is left out: nothing reads it there
    either, and the port's master weights take ``ParamSpec.dtype`` (f32).
    So is its ``backend``: the port dispatches on the device.
    """
    mode: str = "bf16"
    compute_dtype: torch.dtype = torch.bfloat16
    fwd_fmt: str = "e4m3"
    bwd_fmt: str = "e5m2"
    fp8_block_rows: int = 128
    fp8_block_cols: int = 128
    fp8_fallback_ratio: float = 8.0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.mode not in PORTED_MODES:
            raise NotImplementedError(
                f"quant mode {self.mode!r} is not ported yet: the port runs "
                f"{PORTED_MODES} (ROADMAP.md Queue 1)")

    @property
    def is_quantized(self) -> bool:
        return self.mode in _SB_VARIANT

    @classmethod
    def from_train_config(cls, tc) -> "QuantPolicy":
        """The policy of a TrainConfig: ``quant_mode`` and the fp8 tile
        knobs, as the JAX launchers derive it."""
        return cls(tc.quant_mode, fp8_block_rows=tc.fp8_block_rows,
                   fp8_block_cols=tc.fp8_block_cols,
                   fp8_fallback_ratio=tc.fp8_fallback_ratio)

    @property
    def fp8(self) -> SB.FP8Config:
        return SB.FP8Config(self.fwd_fmt, self.bwd_fmt, self.fp8_block_rows,
                            self.fp8_block_cols, self.fp8_fallback_ratio)


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

    ``x``: (..., n) activations; ``w``: (n, m) the weight, which the
    model's layers hand over cast to the compute dtype (``use_weight``).
    Ẇ comes back in w's dtype. The JAX package widens the weight to f32
    before the quantized modes quantize it; the widening is exact, so the
    kernels quantize the compute-dtype weight directly and see the same
    values.
    """
    cd = policy.compute_dtype
    n = x.shape[-1]
    lead = x.shape[:-1]
    if policy.is_quantized:
        return SB.switchback_linear(x.to(cd), w, b,
                                    variant=_SB_VARIANT[policy.mode],
                                    compute_dtype=cd, fp8=policy.fp8)
    y = Dense16Matmul.apply(x.reshape(-1, n), w, cd).reshape(*lead, w.shape[-1])
    if b is not None:
        y = y + b.to(y.dtype)
    return y
