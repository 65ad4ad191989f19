"""Public wrappers for the SwitchBack kernels, forward and input gradient:
dispatch by device.

A tensor on the CPU goes to the plain version in ``ref.py``. A tensor on
the card goes to the hand-written CUDA kernel (``csrc/switchback.cu``),
or the wrapper raises: there is no switch that sends a CUDA tensor to the
plain version, and no fallback when the build or a launch fails.

The kernels mask their ragged edges themselves, so unlike the JAX
package's ops (which pad to TPU block multiples) nothing is padded here.

Each wrapper counts its launches in ``LAUNCHES``, keyed by kernel name,
incremented only where it launches its kernel. The two matmul wrappers
count their column-scale form apart (``int8_matmul_dequant_colscale``,
``int8_matmul_dequant_colscale_t``): it is the colscale branch of the TPU
kernel. ``launch_counts``/``reset_launch_counts`` read and zero them all.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.switchback import ref as _ref

# Above this contraction the forward takes the two-step row-quantize ->
# tiled-matmul path instead of the fused kernel: the same split as the JAX
# package's ``repro/kernels/switchback/ops.py`` (FUSED_MAX_CONTRACT), kept
# so both packages run the same kernels on the same layers.
FUSED_MAX_CONTRACT = 2048

_FLOAT_TYPES = (torch.float32, torch.bfloat16)
# scratch for tensor_quantize's first pass: one partial max per block
_MAX_PARTIALS = 1024
_PARTIAL_ELEMS = 2048            # elements per pass-1 block before capping


LAUNCHES = dict.fromkeys((
    "tensor_quantize", "fused_switchback_fwd", "row_quantize", "col_quantize",
    "int8_matmul_dequant", "int8_matmul_dequant_colscale", "fused_switchback_dgrad",
    "int8_matmul_dequant_t", "int8_matmul_dequant_colscale_t"), 0)


def _lib():
    from repro_torch.kernels.switchback.build import load
    return load()


def row_quantize(x: torch.Tensor):
    """x (B, K) f32/bf16 -> (q int8 (B, K), state f32 (B, 1))  (Eq. 1)."""
    _b.need(x, "x", _FLOAT_TYPES, 2)
    if _b.on_cpu(x):
        return _ref.row_quantize(x)
    B, K = x.shape
    q = torch.empty((B, K), dtype=torch.int8, device=x.device)
    s = torch.empty((B, 1), dtype=torch.float32, device=x.device)
    _b.launch(_lib().sb_row_quantize, x.data_ptr(), int(x.dtype == torch.bfloat16),
              q.data_ptr(), s.data_ptr(), B, K, _b.stream(x))
    LAUNCHES["row_quantize"] += 1
    return q, s


def col_quantize(x: torch.Tensor):
    """x (R, C) f32/bf16 -> (q int8 (R, C), state f32 (1, C)): one scale
    per column (the column-wise weight state of paper Eq. 4)."""
    _b.need(x, "x", _FLOAT_TYPES, 2)
    if _b.on_cpu(x):
        return _ref.col_quantize(x)
    R, C = x.shape
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    s = torch.empty((1, C), dtype=torch.float32, device=x.device)
    _b.launch(_lib().sb_col_quantize, x.data_ptr(), int(x.dtype == torch.bfloat16),
              q.data_ptr(), s.data_ptr(), R, C, _b.stream(x))
    LAUNCHES["col_quantize"] += 1
    return q, s


def tensor_quantize(x: torch.Tensor):
    """x (R, C) f32/bf16 -> (q int8 (R, C), state f32 (1, 1))  (Eq. 2)."""
    _b.need(x, "x", _FLOAT_TYPES, 2)
    if _b.on_cpu(x):
        return _ref.tensor_quantize(x)
    n = x.numel()
    n_partial = max(1, min(_MAX_PARTIALS, -(-n // _PARTIAL_ELEMS)))
    partial = torch.empty((n_partial,), dtype=torch.float32, device=x.device)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    _b.launch(_lib().sb_tensor_quantize, x.data_ptr(), int(x.dtype == torch.bfloat16),
              n, partial.data_ptr(), n_partial, q.data_ptr(), s.data_ptr(),
              _b.stream(x))
    LAUNCHES["tensor_quantize"] += 1
    return q, s


def _check_weight(w_q: torch.Tensor, K: int):
    _b.need(w_q, "w_q", (torch.int8,), 2)
    if w_q.shape[0] != K:
        raise ValueError(f"w_q {tuple(w_q.shape)} does not contract with K={K}")


def fused_switchback_fwd(x: torch.Tensor, w_q: torch.Tensor,
                         s_w: torch.Tensor) -> torch.Tensor:
    """Row-quantize x inside the int8 matmul: x (B, K) f32/bf16, w_q (K, M)
    int8, s_w (1, 1) f32 -> (B, M) in x's dtype."""
    _b.need(x, "x", _FLOAT_TYPES, 2)
    _check_weight(w_q, x.shape[1])
    _b.need(s_w, "s_w", (torch.float32,), 2)
    if s_w.numel() != 1:
        raise ValueError(f"s_w must hold one value, got shape {tuple(s_w.shape)}")
    if _b.on_cpu(x, w_q, s_w):
        return _ref.fused_switchback_fwd(x, w_q, s_w)
    B, K = x.shape
    M = w_q.shape[1]
    y = torch.empty((B, M), dtype=x.dtype, device=x.device)
    _b.launch(_lib().sb_fused_switchback_fwd, x.data_ptr(),
              int(x.dtype == torch.bfloat16), w_q.data_ptr(),
              s_w.data_ptr(), y.data_ptr(), B, K, M, _b.stream(x))
    LAUNCHES["fused_switchback_fwd"] += 1
    return y


def _check_scales(row_scale, col_scale, B: int, M: int, out_dtype):
    _b.need(row_scale, "row_scale", (torch.float32,), 2)
    if tuple(row_scale.shape) != (B, 1):
        raise ValueError(f"row_scale {tuple(row_scale.shape)} != {(B, 1)}")
    if col_scale is not None:
        _b.need(col_scale, "col_scale", (torch.float32,), 2)
        if tuple(col_scale.shape) != (1, M):
            raise ValueError(f"col_scale {tuple(col_scale.shape)} != {(1, M)}")
    if out_dtype not in _FLOAT_TYPES:
        raise TypeError(f"out_dtype {out_dtype} not in {_FLOAT_TYPES}")


def _matmul(entry, names, x_q, w_q, row_scale, col_scale, M, out_dtype):
    """Launch one of the two int8 matmul entry points (the column scale as
    a null pointer when there is none) and count it under its form:
    ``names`` = (row-scale form, colscale form)."""
    B, K = x_q.shape
    y = torch.empty((B, M), dtype=out_dtype, device=x_q.device)
    _b.launch(entry, x_q.data_ptr(), w_q.data_ptr(), row_scale.data_ptr(),
              None if col_scale is None else col_scale.data_ptr(), y.data_ptr(),
              int(out_dtype == torch.bfloat16), B, K, M, _b.stream(x_q))
    LAUNCHES[names[col_scale is not None]] += 1
    return y


def int8_matmul_dequant(x_q: torch.Tensor, w_q: torch.Tensor,
                        row_scale: torch.Tensor, *, col_scale: torch.Tensor | None = None,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = row_scale * (x_q . w_q) with int32 accumulation: x_q (B, K) int8,
    w_q (K, M) int8, row_scale (B, 1) f32 (already s_x * s_w / 127^2).
    With ``col_scale`` (1, M) f32, the column-wise weight state of Eq. 4,
    y = (row_scale * col_scale) * (x_q . w_q): the rank-1 epilogue."""
    _b.need(x_q, "x_q", (torch.int8,), 2)
    _check_weight(w_q, x_q.shape[1])
    M = w_q.shape[1]
    _check_scales(row_scale, col_scale, x_q.shape[0], M, out_dtype)
    tensors = (x_q, w_q, row_scale) + (() if col_scale is None else (col_scale,))
    if _b.on_cpu(*tensors):
        return _ref.int8_matmul_dequant(x_q, w_q, row_scale, col_scale=col_scale,
                                        out_dtype=out_dtype)
    return _matmul(_lib().sb_int8_matmul_dequant,
                   ("int8_matmul_dequant", "int8_matmul_dequant_colscale"), x_q, w_q,
                   row_scale, col_scale, M, out_dtype)


def fused_switchback_dgrad(g: torch.Tensor, w_q: torch.Tensor,
                           s_w: torch.Tensor) -> torch.Tensor:
    """Input gradient with the row-quantize of g fused into the int8
    matmul: g (B, M) f32/bf16, w_q (N, M) int8 as the forward quantized it,
    s_w (1, 1) f32 -> dx (B, N) = s_g * s_w / 127^2 * (q(g) . w_q^T), in
    g's dtype. The contraction runs over w_q's second dim (no transpose)."""
    _b.need(g, "g", _FLOAT_TYPES, 2)
    _b.need(w_q, "w_q", (torch.int8,), 2)
    if w_q.shape[1] != g.shape[1]:
        raise ValueError(f"w_q {tuple(w_q.shape)} does not contract with M={g.shape[1]}")
    _b.need(s_w, "s_w", (torch.float32,), 2)
    if s_w.numel() != 1:
        raise ValueError(f"s_w must hold one value, got shape {tuple(s_w.shape)}")
    if _b.on_cpu(g, w_q, s_w):
        return _ref.fused_switchback_dgrad(g, w_q, s_w)
    B, M = g.shape
    N = w_q.shape[0]
    dx = torch.empty((B, N), dtype=g.dtype, device=g.device)
    _b.launch(_lib().sb_fused_switchback_dgrad, g.data_ptr(),
              int(g.dtype == torch.bfloat16), w_q.data_ptr(),
              s_w.data_ptr(), dx.data_ptr(), B, M, N, _b.stream(g))
    LAUNCHES["fused_switchback_dgrad"] += 1
    return dx


def int8_matmul_dequant_t(x_q: torch.Tensor, w_q: torch.Tensor,
                          row_scale: torch.Tensor, *, col_scale: torch.Tensor | None = None,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """The JAX package's ``int8_matmul_dequant(..., transpose_w=True)``:
    x_q (B, K) int8, w_q (M, K) int8, row_scale (B, 1) f32 ->
    y (B, M) = row_scale * (x_q . w_q^T), int32 accumulation. The two-step
    dgrad of a layer whose output width is above ``FUSED_MAX_CONTRACT``;
    with ``col_scale`` (1, M) the dgrad of the column-wise variants
    (w_q row-quantized, its (M, 1) state transposed)."""
    _b.need(x_q, "x_q", (torch.int8,), 2)
    _b.need(w_q, "w_q", (torch.int8,), 2)
    B, K = x_q.shape
    if w_q.shape[1] != K:
        raise ValueError(f"w_q {tuple(w_q.shape)} does not contract with K={K}")
    M = w_q.shape[0]
    _check_scales(row_scale, col_scale, B, M, out_dtype)
    tensors = (x_q, w_q, row_scale) + (() if col_scale is None else (col_scale,))
    if _b.on_cpu(*tensors):
        return _ref.int8_matmul_dequant_t(x_q, w_q, row_scale, col_scale=col_scale,
                                          out_dtype=out_dtype)
    return _matmul(_lib().sb_int8_matmul_dequant_t,
                   ("int8_matmul_dequant_t", "int8_matmul_dequant_colscale_t"), x_q, w_q,
                   row_scale, col_scale, M, out_dtype)


KERNELS = (tensor_quantize, fused_switchback_fwd, row_quantize, col_quantize,
           int8_matmul_dequant, fused_switchback_dgrad, int8_matmul_dequant_t)


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
