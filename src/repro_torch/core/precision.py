"""Precision policy: how every linear layer computes.

The PyTorch counterpart of ``repro/core/precision.py``. Every linear goes
through ``quant_linear``; ``QuantPolicy.mode`` picks the plain 16-bit
product (``bf16``, the paper's baseline) or the SwitchBack int8 forward
(``int8_switchback``, alias ``int8``). The JAX package's other modes
raise ``NotImplementedError`` until their slice is ported.

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


def quant_linear(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor | None = None, *,
                 policy: QuantPolicy = BF16) -> torch.Tensor:
    """The single entry point for every linear layer.

    ``x``: (..., n) activations; ``w``: (n, m) weights as the layer
    prepared them (``params.use_weight`` casts to the compute dtype).
    The JAX package widens ``w`` to f32 before quantizing; that widening
    is exact, so the kernel reads the compute-dtype weight directly and
    quantizes the same values.
    """
    if policy.is_quantized:
        return SB.switchback_linear(x.to(policy.compute_dtype), w, b,
                                    variant=_SB_VARIANT[policy.mode])
    cd = policy.compute_dtype
    y = torch.matmul(x.to(cd), w.to(cd))
    if b is not None:
        y = y + b.to(y.dtype)
    return y
