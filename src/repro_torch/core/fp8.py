"""Bit-exact float8 (E4M3 / E5M2) simulation from first principles.

The PyTorch counterpart of ``repro/core/fp8.py``. The paper (§2.2.1)
simulates fp8 by "rounding to the exact values of the float8 data type"
while computing in wider types. ``core/quantization.fp8_grid_round``
rounds with an f32 bit trick; this module rounds by decomposing each
magnitude with frexp/ldexp, independently of that trick and of torch's
float8 dtypes, and is the oracle the two are checked against.

Formats follow Micikevicius et al., "FP8 formats for deep learning":

  E4M3 (fn): 1 sign, 4 exp (bias 7),  3 mantissa. Max normal 448.
             No infinities; S.1111.111 is NaN. Subnormal min 2^-9.
  E5M2:      1 sign, 5 exp (bias 15), 2 mantissa. Max normal 57344.
             IEEE-like: has inf/NaN. Subnormal min 2^-16.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class FP8Spec:
    name: str
    exp_bits: int
    man_bits: int
    bias: int
    max_value: float        # largest finite magnitude


E4M3 = FP8Spec("e4m3", exp_bits=4, man_bits=3, bias=7, max_value=448.0)
E5M2 = FP8Spec("e5m2", exp_bits=5, man_bits=2, bias=15, max_value=57344.0)
SPECS = {"e4m3": E4M3, "e5m2": E5M2}

_TINY = torch.finfo(torch.float32).tiny


def fp8_values(spec: FP8Spec) -> np.ndarray:
    """Every finite non-negative value of the format, ascending (float64)."""
    vals = [0.0]
    for m in range(1, 2 ** spec.man_bits):                      # subnormals
        vals.append(m / 2 ** spec.man_bits * 2.0 ** (1 - spec.bias))
    for e in range(1, 2 ** spec.exp_bits):                      # normals
        for m in range(2 ** spec.man_bits):
            v = (1 + m / 2 ** spec.man_bits) * 2.0 ** (e - spec.bias)
            if v <= spec.max_value:
                vals.append(v)
    return np.unique(np.asarray(vals, dtype=np.float64))


def _step(mag: torch.Tensor, spec: FP8Spec) -> torch.Tensor:
    """2^(max(floor(log2 mag), 1 - bias) - man_bits), exact: frexp gives
    mag = m·2^e with m in [0.5, 1) exactly (log2 is off by an ulp at some
    inputs), and a power of two is exact in f32."""
    _, e = torch.frexp(mag.clamp_min(_TINY))
    exp = torch.clamp_min(e - 1, 1 - spec.bias)
    return torch.ldexp(torch.ones_like(mag), exp - spec.man_bits)


def fp8_round(x: torch.Tensor, spec: FP8Spec) -> torch.Tensor:
    """Round to nearest, ties to even, onto the fp8 grid, saturating at
    ``max_value``; computed in f32 and returned in x's dtype."""
    xf = x.float()
    mag = xf.abs().clamp_max(spec.max_value)
    step = _step(mag, spec)
    # mag / step is exact (step is a power of two); torch.round is half to even
    out = torch.round(mag / step) * step
    # a carry into the next binade is representable but may pass the max
    out = out.clamp_max(spec.max_value)
    out = torch.where(mag == 0.0, torch.zeros_like(out), out)
    # x's sign, a zero's too (the reference's sign(x) * out: jnp.sign(-0.0)
    # is -0.0, where torch.sign gives +0.0)
    return torch.copysign(out, xf).to(x.dtype)


def fp8_quantization_step(mag: torch.Tensor, spec: FP8Spec) -> torch.Tensor:
    """The rounding step at magnitude ``mag``: |fp8_round(x) - x| <= step/2."""
    return _step(mag.float().abs(), spec)
