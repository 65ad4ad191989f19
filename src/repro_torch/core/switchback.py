"""SwitchBack linear, forward only (paper §2.2, Eq. 3).

The PyTorch counterpart of ``repro/core/switchback.py`` for serving: the
``switchback`` variant's forward, row-wise int8 X against tensor-wise int8
W, through the kernels in ``kernels/switchback``. Serving needs no
gradient; the ``torch.autograd.Function`` with the int8 dgrad kernel and
the 16-bit weight gradient comes with the training slice, and the other
variants (switchback_m / _q, llm_int8, the fp8 family) after it.

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
    tiled int8 matmul (same math). The output has x's dtype."""
    w_q, s_w = KOPS.tensor_quantize(w)                       # (n, m), (1, 1)
    if x.shape[1] <= KOPS.FUSED_MAX_CONTRACT:
        y = KOPS.fused_switchback_fwd(x, w_q, s_w)
    else:
        x_q, s_x = KOPS.row_quantize(x)
        y = KOPS.int8_matmul_dequant(x_q, w_q, s_x * Q.div(s_w, _I2),
                                     out_dtype=x.dtype)
    return y


def switchback_linear(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor | None = None, *,
                      variant: str = "switchback") -> torch.Tensor:
    """SwitchBack linear on ``x`` (..., n) with ``w`` (n, m): leading dims
    flatten into rows (one row-wise scale per token) and are restored.
    The output has x's dtype."""
    if variant not in VARIANTS:
        raise NotImplementedError(
            f"SwitchBack variant {variant!r} is not ported yet: this slice "
            f"serves {VARIANTS}; the other variants follow the training slice")
    n = x.shape[-1]
    lead = x.shape[:-1]
    y2 = _kfwd_rowwise_tensorwise(x.reshape(-1, n).contiguous(), w)
    y = y2.reshape(*lead, w.shape[-1])
    if b is not None:
        y = y + b.to(y.dtype)
    return y
