"""Public wrappers for the fp8 kernels: dispatch by device.

The port of ``repro/kernels/fp8_matmul/ops.py``. A tensor on the CPU goes
to the plain version in ``ref.py``. A tensor on the card goes to the
hand-written CUDA kernel (``csrc/fp8_matmul.cu``), or the wrapper raises:
there is no switch that sends a CUDA tensor to the plain version, and no
fallback when the build or a launch fails.

fp8 tensors are ``torch.float8_e4m3fn`` or ``torch.float8_e5m2``; a
matmul reads each operand's format from its dtype. The kernels mask their
ragged edges themselves, so nothing is padded here; the states keep the
tile grid of the JAX package's zero-padded arrays. ``fp8_matmul_dequant``
accumulates over the k-blocks of ``ref.choose_blocks`` (the JAX package's
split), in both the kernel and the plain version. ``fallback_mask`` is a
plain op on the tiny tile state on either device, not a kernel; ``mixed``
chains ``block_quantize``, ``fallback_mask`` and ``fp8_mixed_matmul`` as
the JAX package's ``fp8_mixed_matmul`` op does.

Each wrapper counts its launches in ``LAUNCHES``, keyed by kernel form,
incremented only where it launches its kernel; the ``_t`` forms (W read
as (M, K), contracted over its second dim: the input gradient) count
apart. ``launch_counts``/``reset_launch_counts`` read and zero them.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import FP8_DTYPES as FMT_DTYPE
from repro_torch.kernels import build as _b
from repro_torch.kernels.fp8_matmul import ref as _ref

# the kernels' format codes, by storage dtype
_FMT_CODE = {FMT_DTYPE["e4m3"]: 0, FMT_DTYPE["e5m2"]: 1}
_FLOAT_TYPES = (torch.float32, torch.bfloat16)
_FP8_TYPES = tuple(_FMT_CODE)
# scratch for tensor_quantize's first pass: one partial max per block
_MAX_PARTIALS = 1024
_PARTIAL_ELEMS = 2048

fallback_mask = _ref.fallback_mask

LAUNCHES = dict.fromkeys((
    "fp8_row_quantize", "fp8_tensor_quantize", "fp8_block_quantize", "fp8_matmul_dequant",
    "fp8_matmul_dequant_t", "fp8_mixed_matmul", "fp8_mixed_matmul_t"), 0)


def _lib():
    from repro_torch.kernels.fp8_matmul.build import load
    return load()


def _fmt(fmt: str) -> int:
    _ref.check_fmt(fmt)
    return _FMT_CODE[FMT_DTYPE[fmt]]


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def row_quantize(x: torch.Tensor, fmt: str = "e4m3"):
    """x (B, K) f32/bf16 -> (q fp8 (B, K), state f32 (B, 1))."""
    _b.need(x, "x", _FLOAT_TYPES, 2)
    code = _fmt(fmt)
    if _b.on_cpu(x):
        return _ref.row_quantize(x, fmt)
    B, K = x.shape
    q = torch.empty((B, K), dtype=FMT_DTYPE[fmt], device=x.device)
    s = torch.empty((B, 1), dtype=torch.float32, device=x.device)
    _b.launch(_lib().f8_row_quantize, x.data_ptr(), _bf16(x), q.data_ptr(), s.data_ptr(),
              B, K, code, _b.stream(x))
    LAUNCHES["fp8_row_quantize"] += 1
    return q, s


def tensor_quantize(x: torch.Tensor, fmt: str = "e4m3"):
    """x (R, C) f32/bf16 -> (q fp8 (R, C), state f32 (1, 1))."""
    _b.need(x, "x", _FLOAT_TYPES, 2)
    code = _fmt(fmt)
    if _b.on_cpu(x):
        return _ref.tensor_quantize(x, fmt)
    n = x.numel()
    n_partial = max(1, min(_MAX_PARTIALS, -(-n // _PARTIAL_ELEMS)))
    partial = torch.empty((n_partial,), dtype=torch.float32, device=x.device)
    q = torch.empty(x.shape, dtype=FMT_DTYPE[fmt], device=x.device)
    s = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    _b.launch(_lib().f8_tensor_quantize, x.data_ptr(), _bf16(x), n, partial.data_ptr(),
              n_partial, q.data_ptr(), s.data_ptr(), code, _b.stream(x))
    LAUNCHES["fp8_tensor_quantize"] += 1
    return q, s


def block_quantize(x: torch.Tensor, fmt: str = "e4m3", block_rows: int = 128,
                   block_cols: int = 128):
    """x (R, C) f32/bf16 -> (q fp8 (R, C), state f32 (⌈R/br⌉, ⌈C/bc⌉)),
    one scale per (br x bc) tile, br = min(block_rows, R), bc likewise."""
    _b.need(x, "x", _FLOAT_TYPES, 2)
    code = _fmt(fmt)
    if block_rows < 1 or block_cols < 1:
        raise ValueError(f"block shape ({block_rows}, {block_cols}) must be positive")
    if _b.on_cpu(x):
        return _ref.block_quantize(x, fmt, block_rows, block_cols)
    R, C = x.shape
    br, bc, nbr, nbc = _ref.tile_grid(R, C, block_rows, block_cols)
    q = torch.empty((R, C), dtype=FMT_DTYPE[fmt], device=x.device)
    s = torch.empty((nbr, nbc), dtype=torch.float32, device=x.device)
    _b.launch(_lib().f8_block_quantize, x.data_ptr(), _bf16(x), q.data_ptr(), s.data_ptr(),
              R, C, br, bc, code, _b.stream(x))
    LAUNCHES["fp8_block_quantize"] += 1
    return q, s


def _check_matmul(x_q, w_q, transpose_w: bool, out_dtype):
    """(B, K, M) of a matmul whose LHS x_q (B, K) contracts with w_q
    (K, M), or (M, K) with ``transpose_w``."""
    _b.need(x_q, "x_q", _FP8_TYPES, 2)
    _b.need(w_q, "w_q", _FP8_TYPES, 2)
    B, K = x_q.shape
    if w_q.shape[1 if transpose_w else 0] != K:
        raise ValueError(f"w_q {tuple(w_q.shape)} does not contract with K={K}"
                         f"{' over its second dim' if transpose_w else ''}")
    if out_dtype not in _FLOAT_TYPES:
        raise TypeError(f"out_dtype {out_dtype} not in {_FLOAT_TYPES}")
    return B, K, w_q.shape[0] if transpose_w else w_q.shape[1]


def _dequant(x_q, w_q, row_scale, transpose_w: bool, out_dtype):
    B, K, M = _check_matmul(x_q, w_q, transpose_w, out_dtype)
    _b.need(row_scale, "row_scale", (torch.float32,), 2)
    if tuple(row_scale.shape) != (B, 1):
        raise ValueError(f"row_scale {tuple(row_scale.shape)} != {(B, 1)}")
    if _b.on_cpu(x_q, w_q, row_scale):
        return _ref.fp8_matmul_dequant(x_q, w_q, row_scale, transpose_w=transpose_w,
                                       out_dtype=out_dtype)
    name = "fp8_matmul_dequant_t" if transpose_w else "fp8_matmul_dequant"
    y = torch.empty((B, M), dtype=out_dtype, device=x_q.device)
    _b.launch(getattr(_lib(), "f8" + name[3:]), x_q.data_ptr(), _FMT_CODE[x_q.dtype],
              w_q.data_ptr(), _FMT_CODE[w_q.dtype], row_scale.data_ptr(), y.data_ptr(),
              int(out_dtype == torch.bfloat16), B, K, M, _ref.block_k(B, K, M),
              _b.stream(x_q))
    LAUNCHES[name] += 1
    return y


def fp8_matmul_dequant(x_q: torch.Tensor, w_q: torch.Tensor, row_scale: torch.Tensor, *,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = row_scale * (x_q . w_q), f32 accumulation over the k-blocks:
    x_q (B, K) fp8, w_q (K, M) fp8, row_scale (B, 1) f32 (the prefolded
    s_x * s_w) -> (B, M) in ``out_dtype``."""
    return _dequant(x_q, w_q, row_scale, False, out_dtype)


def fp8_matmul_dequant_t(x_q: torch.Tensor, w_q: torch.Tensor, row_scale: torch.Tensor, *,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """The JAX ``fp8_matmul_dequant(..., transpose_w=True)``: w_q (M, K),
    y (B, M) = row_scale * (x_q . w_q^T) (the input gradient against the
    forward's fp8 W, never transposed)."""
    return _dequant(x_q, w_q, row_scale, True, out_dtype)


def _mixed(x16, x_q, s_blk, fb_blk, w_q, s_w, block_rows, block_cols, transpose_w, out_dtype):
    B, K, M = _check_matmul(x_q, w_q, transpose_w, out_dtype)
    _b.need(x16, "x16", _FLOAT_TYPES, 2)
    if tuple(x16.shape) != (B, K):
        raise ValueError(f"x16 {tuple(x16.shape)} != x_q {(B, K)}")
    br, bk, nbr, nbk = _ref.tile_grid(B, K, block_rows, block_cols)
    for t, name in ((s_blk, "s_blk"), (fb_blk, "fb_blk")):
        _b.need(t, name, (torch.float32,), 2)
        if tuple(t.shape) != (nbr, nbk):
            raise ValueError(f"{name} {tuple(t.shape)} != the tile grid {(nbr, nbk)}")
    _b.need(s_w, "s_w", (torch.float32,), 2)
    if s_w.numel() != 1:
        raise ValueError(f"s_w must hold one value, got shape {tuple(s_w.shape)}")
    if _b.on_cpu(x16, x_q, s_blk, fb_blk, w_q, s_w):
        return _ref.fp8_mixed_matmul(x16, x_q, s_blk, fb_blk, w_q, s_w, block_rows=block_rows,
                                     block_cols=block_cols, transpose_w=transpose_w,
                                     out_dtype=out_dtype)
    name = "fp8_mixed_matmul_t" if transpose_w else "fp8_mixed_matmul"
    y = torch.empty((B, M), dtype=out_dtype, device=x_q.device)
    _b.launch(getattr(_lib(), "f8" + name[3:]), x16.data_ptr(), _bf16(x16), x_q.data_ptr(),
              _FMT_CODE[x_q.dtype], s_blk.data_ptr(), fb_blk.data_ptr(), w_q.data_ptr(),
              _FMT_CODE[w_q.dtype], s_w.data_ptr(), y.data_ptr(),
              int(out_dtype == torch.bfloat16), B, K, M, br, bk, _b.stream(x_q))
    LAUNCHES[name] += 1
    return y


def fp8_mixed_matmul(x16: torch.Tensor, x_q: torch.Tensor, s_blk: torch.Tensor,
                     fb_blk: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, *,
                     block_rows: int = 128, block_cols: int = 128,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """The mixed fp8/bf16 matmul over ``block_quantize``'s tiles: x16 (B, K)
    f32/bf16 the unquantized operand (read on fallback tiles only), x_q
    (B, K) fp8 with per-tile s_blk and mask fb_blk, w_q (K, M) fp8 with
    tensor scale s_w (1, 1) -> (B, M) in ``out_dtype``."""
    return _mixed(x16, x_q, s_blk, fb_blk, w_q, s_w, block_rows, block_cols, False, out_dtype)


def fp8_mixed_matmul_t(x16: torch.Tensor, x_q: torch.Tensor, s_blk: torch.Tensor,
                       fb_blk: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, *,
                       block_rows: int = 128, block_cols: int = 128,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """The ``transpose_w`` form: w_q (M, K), contracted over its second dim."""
    return _mixed(x16, x_q, s_blk, fb_blk, w_q, s_w, block_rows, block_cols, True, out_dtype)


def mixed(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, *, fmt: str = "e4m3",
          block_rows: int = 128, block_cols: int = 128, fallback_ratio: float = 8.0,
          transpose_w: bool = False, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The JAX package's ``fp8_mixed_matmul`` op: block-quantize x in
    (block_rows x block_cols) tiles, mark the tiles whose absmax exceeds
    ``fallback_ratio`` x the median, and run the mixed matmul (fallback
    tiles in bf16 against the dequantized W, the rest in fp8)."""
    x_q, s_blk = block_quantize(x, fmt, block_rows, block_cols)
    fb = fallback_mask(s_blk, fallback_ratio)
    fn = fp8_mixed_matmul_t if transpose_w else fp8_mixed_matmul
    return fn(x, x_q, s_blk, fb, w_q, s_w, block_rows=block_rows, block_cols=block_cols,
              out_dtype=out_dtype)


KERNELS = (row_quantize, tensor_quantize, block_quantize, fp8_matmul_dequant,
           fp8_matmul_dequant_t, fp8_mixed_matmul, fp8_mixed_matmul_t)


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
