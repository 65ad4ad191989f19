"""Public wrappers for the fp8 kernels: dispatch by device.

The port of ``repro/kernels/fp8_matmul/ops.py``. A tensor on the CPU goes
to the plain version in ``ref.py``. A tensor on the card goes to the
hand-written CUDA kernel (``csrc/fp8_matmul.cu``), or the wrapper raises:
there is no switch that sends a CUDA tensor to the plain version, and no
fallback when the build or a launch fails.

fp8 tensors are ``torch.float8_e4m3fn`` or ``torch.float8_e5m2``; a
matmul reads each operand's format from its dtype. The kernels mask their
ragged edges themselves, so nothing is padded here; the states keep the
tile grid of the JAX package's zero-padded arrays. The matmul kernels run
on fp8 wgmma, which reads W K-major only: the ``_t`` forms' W (M, K) is,
and the forward's W (K, M) goes to the same kernel as a K-major copy. On
the paths that copy comes from the quantizer itself
(``tensor_quantize_kt``, which writes W's codes row-major and K-major from
the same registers) and is handed to the forward as ``w_k``; without
``w_k`` the wrapper makes it first with the ``transpose_bytes`` kernel
(``_k_major``; its time is part of the wrapper's, its launches count
apart), an op entry point on no path. ``fp8_matmul_dequant``
accumulates over the k-blocks of ``ref.choose_blocks`` (the JAX package's
split), in both the kernel and the plain version. ``fallback_mask`` is a
plain op on the tiny tile state on either device, not a kernel; ``mixed``
chains ``block_quantize``, ``fallback_mask`` and ``fp8_mixed_matmul`` as
the JAX package's ``fp8_mixed_matmul`` op does.

Each wrapper counts its launches in ``LAUNCHES``, keyed by kernel form,
incremented only where it launches its kernel; the ``_t`` forms (W read
as (M, K), contracted over its second dim: the input gradient) count
apart, and ``tensor_quantize_kt`` counts under ``fp8_tensor_quantize``
(one CUDA kernel a call, as ``tensor_quantize``).
``launch_counts``/``reset_launch_counts`` read and zero them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantization import FP8_DTYPES as FMT_DTYPE
from repro_torch.kernels import build as _b
from repro_torch.kernels.fp8_matmul import ref as _ref

# the kernels' format codes, by storage dtype
_FMT_CODE = {FMT_DTYPE["e4m3"]: 0, FMT_DTYPE["e5m2"]: 1}
_FLOAT_TYPES = (torch.float32, torch.bfloat16)
_FP8_TYPES = tuple(_FMT_CODE)
# tensor_quantize's partial maxima, one a block: the most blocks its
# launcher takes (kMaxPartials, kernels/csrc/tensor_absmax.cuh)
MAX_PARTIALS = 1024

fallback_mask = _ref.fallback_mask

LAUNCHES = dict.fromkeys((
    "fp8_row_quantize", "fp8_tensor_quantize", "fp8_block_quantize", "fp8_matmul_dequant",
    "fp8_matmul_dequant_t", "fp8_mixed_matmul", "fp8_mixed_matmul_t", "fp8_transpose_bytes"), 0)


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


def _tensor(x: torch.Tensor, fmt: str, drop=None):
    """One launch of the tensor quantizer on a CUDA x (its two passes
    past the registers): the partials allocated here, the stream's barrier
    workspace; with ``drop``, the control fault's entry point."""
    q = torch.empty(x.shape, dtype=FMT_DTYPE[fmt], device=x.device)
    s = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    partial = torch.empty((MAX_PARTIALS,), dtype=torch.float32, device=x.device)
    st = _b.stream(x)
    args = (x.data_ptr(), _bf16(x), x.numel(), partial.data_ptr(),
            _b.grid_barrier(x.device, st).data_ptr(), q.data_ptr(), s.data_ptr(), _fmt(fmt))
    if drop is None:
        _b.launch(_lib().f8_tensor_quantize, *args, st)
    else:
        _b.launch(_lib().f8_tensor_quantize_drop, *args, drop, st)
    return q, s


def tensor_quantize(x: torch.Tensor, fmt: str = "e4m3"):
    """x (R, C) f32/bf16 -> (q fp8 (R, C), state f32 (1, 1))."""
    _b.need(x, "x", _FLOAT_TYPES, 2)
    _fmt(fmt)
    if _b.on_cpu(x):
        return _ref.tensor_quantize(x, fmt)
    out = _tensor(x, fmt)
    LAUNCHES["fp8_tensor_quantize"] += 1
    return out


def tensor_quantize_drop(x: torch.Tensor, fmt: str, drop: int):
    """The checks' control fault: ``tensor_quantize`` with block ``drop``'s
    partial maximum left out of the absmax. CUDA tensors only, not a path's
    entry point and not counted in ``LAUNCHES``."""
    _b.need(x, "x", _FLOAT_TYPES, 2)
    if _b.on_cpu(x):
        raise ValueError("tensor_quantize_drop launches the kernel: x must lie on the card")
    return _tensor(x, fmt, drop)


def tensor_quantize_plan(x: torch.Tensor) -> dict:
    """The launch plan ``tensor_quantize`` takes for x (``build.plan``;
    the same in both formats)."""
    _b.need(x, "x", _FLOAT_TYPES, 2)
    return _b.plan(_lib().f8_tensor_quantize_plan, x)


def _tensor_kt(x: torch.Tensor, fmt: str, drop: int = -1, skip: int = -1):
    """One launch of the K-major tensor quantizer on a CUDA x (its two
    passes past the registers); with ``drop`` or ``skip`` the control
    faults' entry point, whose q_k starts as 0xff bytes (a NaN code in both
    formats, which the quantizer never writes), so that an unwritten tile
    shows."""
    R, C = x.shape
    q = torch.empty((R, C), dtype=FMT_DTYPE[fmt], device=x.device)
    s = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    faulty = drop >= 0 or skip >= 0
    if faulty:
        q_k = torch.full((C, R), 255, dtype=torch.uint8, device=x.device)
    else:
        q_k = torch.empty((C, R), dtype=torch.uint8, device=x.device)
    partial = torch.empty((MAX_PARTIALS,), dtype=torch.float32, device=x.device)
    st = _b.stream(x)
    args = (x.data_ptr(), _bf16(x), R, C, partial.data_ptr(),
            _b.grid_barrier(x.device, st).data_ptr(), q.data_ptr(), q_k.data_ptr(),
            s.data_ptr(), _fmt(fmt))
    if faulty:
        _b.launch(_lib().f8_tensor_quantize_kt_fault, *args, drop, skip, st)
    else:
        _b.launch(_lib().f8_tensor_quantize_kt, *args, st)
    return q, s, q_k


def _need_nonempty(x: torch.Tensor):
    _b.need(x, "x", _FLOAT_TYPES, 2)
    if x.numel() == 0:
        raise ValueError(f"x {tuple(x.shape)} is empty")


def tensor_quantize_kt(x: torch.Tensor, fmt: str = "e4m3"):
    """x (K, M) f32/bf16 -> (q fp8 (K, M), state f32 (1, 1), q_k uint8
    (M, K)): ``tensor_quantize``'s q and state, and q's bytes K-major
    (``q.view(torch.uint8).t().contiguous()``), the forward GEMMs' W
    (``w_k``). On the card one CUDA kernel a call writes both copies from
    the same registers; counted under ``fp8_tensor_quantize``."""
    _need_nonempty(x)
    _fmt(fmt)
    if _b.on_cpu(x):
        q, s = _ref.tensor_quantize(x, fmt)
        return q, s, q.view(torch.uint8).t().contiguous()
    out = _tensor_kt(x, fmt)
    LAUNCHES["fp8_tensor_quantize"] += 1
    return out


def tensor_quantize_kt_fault(x: torch.Tensor, fmt: str, drop: int = -1, skip: int = -1):
    """The checks' control faults: ``tensor_quantize_kt`` with block
    ``drop``'s partial maximum left out of the absmax, or block ``skip``'s
    tile of q_k left unwritten (0xff). CUDA tensors only, not a path's entry
    point and not counted in ``LAUNCHES``."""
    _need_nonempty(x)
    if _b.on_cpu(x):
        raise ValueError("tensor_quantize_kt_fault launches the kernel: x must lie on the card")
    if drop < 0 and skip < 0:
        raise ValueError("tensor_quantize_kt_fault needs a fault: drop or skip")
    return _tensor_kt(x, fmt, drop, skip)


KT_PLAN_KEYS = ("blocks", "rounds", "granule", "resident", "block_values", "tile_rows",
                "tile_cols", "tiles")


def tensor_quantize_kt_plan(x: torch.Tensor) -> dict:
    """The launch plan ``tensor_quantize_kt`` takes for x (q and q_k as the
    wrapper allocates them): its blocks, its rounds (0: the one launch, one
    tile a block; else the two passes' tiles a block), the granule, the
    kernel's resident blocks, the values a block holds in one round, the
    tile (rows, columns) and the tiles. Host only; it loads the library."""
    _need_nonempty(x)
    out = (ctypes.c_int * len(KT_PLAN_KEYS))()
    _b.launch(_lib().f8_tensor_quantize_kt_plan, x.data_ptr(), _bf16(x), None, None,
              x.shape[0], x.shape[1], ctypes.addressof(out))
    return dict(zip(KT_PLAN_KEYS, out))


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


def encode_check(fmt: str = "e4m3", device="cuda") -> int:
    """The bytes, over every f32 bit pattern y, where the quantizers'
    conversion on the card (NaN to -max, then round to nearest even onto
    the fp8 grid) differs from ``encode(grid_round(y))``, the plain
    versions' rounding: 0 on a sound card. A check of the kernels' arithmetic
    (the ``encode_check`` kernel, a few milliseconds), not a wrapper: it is
    not counted in ``LAUNCHES``."""
    code = _fmt(fmt)
    bad = torch.zeros((1,), dtype=torch.int64, device=device)
    _b.launch(_lib().f8_encode_check, code, bad.data_ptr(), _b.stream(bad))
    return int(bad.item())


def divide_check(device="cuda") -> int:
    """The differences between the bf16 quantizers' division (a reciprocal
    once a tile, an fma correction) and the IEEE division ``__fdiv_rn``,
    over every bf16 x and every absmax a bf16 row or tile can have below
    2^126 with |x| <= absmax (or x NaN): the pairs whose E4M3 or E5M2 byte
    differs, and whose quotient's bits differ where |x| >= 2^-100 and the
    quotient is normal. 0 on a sound card. A check of the kernels' arithmetic (the
    ``divide_check`` kernel), not counted in ``LAUNCHES``."""
    bad = torch.zeros((1,), dtype=torch.int64, device=device)
    _b.launch(_lib().f8_divide_check, bad.data_ptr(), _b.stream(bad))
    return int(bad.item())


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


def transpose_bytes(w_q: torch.Tensor) -> torch.Tensor:
    """The forward's W (K, M) fp8 as the (M, K) K-major bytes (uint8) that
    the matmul kernels read."""
    _b.need(w_q, "w_q", _FP8_TYPES, 2)
    if _b.on_cpu(w_q):
        return w_q.view(torch.uint8).t().contiguous()
    K, M = w_q.shape
    w_t = torch.empty((M, K), dtype=torch.uint8, device=w_q.device)
    _b.launch(_lib().f8_transpose_bytes, w_q.data_ptr(), w_t.data_ptr(), K, M, _b.stream(w_q))
    LAUNCHES["fp8_transpose_bytes"] += 1
    return w_t


def _k_major(w_q, transpose_w: bool, w_k=None) -> torch.Tensor:
    """W as the (M, K) K-major bytes the matmul kernels read: the ``_t``
    forms' as it lies, the forward's (K, M) as the given ``w_k`` (the
    quantizer's copy) or else through ``transpose_bytes``."""
    if transpose_w:
        return w_q
    return transpose_bytes(w_q) if w_k is None else w_k


def _check_w_k(w_k, w_q, transpose_w: bool):
    """``w_k``, the forward's W (K, M) as its (M, K) K-major bytes."""
    if w_k is None:
        return
    if transpose_w:
        raise ValueError("w_k is the forward's K-major W: the _t forms read w_q as it lies")
    _b.need(w_k, "w_k", (torch.uint8,), 2)
    if tuple(w_k.shape) != tuple(w_q.shape[::-1]):
        raise ValueError(f"w_k {tuple(w_k.shape)} != w_q {tuple(w_q.shape)} transposed")


def _plain_w(w_q, transpose_w: bool, w_k):
    """The plain versions' W and orientation: with ``w_k``, its bytes as
    w_q's fp8 dtype in the ``transpose_w`` form (the same function)."""
    return (w_q, transpose_w) if w_k is None else (w_k.view(w_q.dtype), True)


def _dequant(x_q, w_q, row_scale, transpose_w: bool, out_dtype, w_k=None):
    B, K, M = _check_matmul(x_q, w_q, transpose_w, out_dtype)
    _b.need(row_scale, "row_scale", (torch.float32,), 2)
    if tuple(row_scale.shape) != (B, 1):
        raise ValueError(f"row_scale {tuple(row_scale.shape)} != {(B, 1)}")
    _check_w_k(w_k, w_q, transpose_w)
    if _b.on_cpu(x_q, w_q, row_scale, *([] if w_k is None else [w_k])):
        w, tw = _plain_w(w_q, transpose_w, w_k)
        return _ref.fp8_matmul_dequant(x_q, w, row_scale, transpose_w=tw, out_dtype=out_dtype)
    y = torch.empty((B, M), dtype=out_dtype, device=x_q.device)
    w_k = _k_major(w_q, transpose_w, w_k)
    _b.launch(_lib().f8_matmul_dequant_t, x_q.data_ptr(), _FMT_CODE[x_q.dtype], w_k.data_ptr(),
              _FMT_CODE[w_q.dtype], row_scale.data_ptr(), y.data_ptr(),
              int(out_dtype == torch.bfloat16), B, K, M, _ref.block_k(B, K, M), _b.stream(x_q))
    LAUNCHES["fp8_matmul_dequant_t" if transpose_w else "fp8_matmul_dequant"] += 1
    return y


def fp8_matmul_dequant(x_q: torch.Tensor, w_q: torch.Tensor, row_scale: torch.Tensor, *,
                       out_dtype=torch.bfloat16, w_k=None) -> torch.Tensor:
    """y = row_scale * (x_q . w_q), f32 accumulation over the k-blocks:
    x_q (B, K) fp8, w_q (K, M) fp8, row_scale (B, 1) f32 (the prefolded
    s_x * s_w) -> (B, M) in ``out_dtype``. ``w_k``: w_q's bytes K-major
    (M, K) uint8, as ``tensor_quantize_kt`` gives them, read in place of
    the wrapper's ``transpose_bytes`` copy."""
    return _dequant(x_q, w_q, row_scale, False, out_dtype, w_k)


def fp8_matmul_dequant_t(x_q: torch.Tensor, w_q: torch.Tensor, row_scale: torch.Tensor, *,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """The JAX ``fp8_matmul_dequant(..., transpose_w=True)``: w_q (M, K),
    y (B, M) = row_scale * (x_q . w_q^T) (the input gradient against the
    forward's fp8 W, never transposed)."""
    return _dequant(x_q, w_q, row_scale, True, out_dtype)


def _mixed(x16, x_q, s_blk, fb_blk, w_q, s_w, block_rows, block_cols, transpose_w, out_dtype,
           w_k=None):
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
    _check_w_k(w_k, w_q, transpose_w)
    if _b.on_cpu(x16, x_q, s_blk, fb_blk, w_q, s_w, *([] if w_k is None else [w_k])):
        w, tw = _plain_w(w_q, transpose_w, w_k)
        return _ref.fp8_mixed_matmul(x16, x_q, s_blk, fb_blk, w, s_w, block_rows=block_rows,
                                     block_cols=block_cols, transpose_w=tw, out_dtype=out_dtype)
    y = torch.empty((B, M), dtype=out_dtype, device=x_q.device)
    w_k = _k_major(w_q, transpose_w, w_k)
    _b.launch(_lib().f8_mixed_matmul_t, x16.data_ptr(), _bf16(x16), x_q.data_ptr(),
              _FMT_CODE[x_q.dtype], s_blk.data_ptr(), fb_blk.data_ptr(), w_k.data_ptr(),
              _FMT_CODE[w_q.dtype], s_w.data_ptr(), y.data_ptr(),
              int(out_dtype == torch.bfloat16), B, K, M, br, bk, _b.stream(x_q))
    LAUNCHES["fp8_mixed_matmul_t" if transpose_w else "fp8_mixed_matmul"] += 1
    return y


def fp8_mixed_matmul(x16: torch.Tensor, x_q: torch.Tensor, s_blk: torch.Tensor,
                     fb_blk: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, *,
                     block_rows: int = 128, block_cols: int = 128,
                     out_dtype=torch.bfloat16, w_k=None) -> torch.Tensor:
    """The mixed fp8/bf16 matmul over ``block_quantize``'s tiles: x16 (B, K)
    f32/bf16 the unquantized operand (read on fallback tiles only), x_q
    (B, K) fp8 with per-tile s_blk and mask fb_blk, w_q (K, M) fp8 with
    tensor scale s_w (1, 1) -> (B, M) in ``out_dtype``. ``w_k`` as in
    ``fp8_matmul_dequant``."""
    return _mixed(x16, x_q, s_blk, fb_blk, w_q, s_w, block_rows, block_cols, False, out_dtype,
                  w_k)


def fp8_mixed_matmul_t(x16: torch.Tensor, x_q: torch.Tensor, s_blk: torch.Tensor,
                       fb_blk: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, *,
                       block_rows: int = 128, block_cols: int = 128,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """The ``transpose_w`` form: w_q (M, K), contracted over its second dim."""
    return _mixed(x16, x_q, s_blk, fb_blk, w_q, s_w, block_rows, block_cols, True, out_dtype)


def mixed(x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, *, fmt: str = "e4m3",
          block_rows: int = 128, block_cols: int = 128, fallback_ratio: float = 8.0,
          transpose_w: bool = False, out_dtype=torch.bfloat16, w_k=None) -> torch.Tensor:
    """The JAX package's ``fp8_mixed_matmul`` op: block-quantize x in
    (block_rows x block_cols) tiles, mark the tiles whose absmax exceeds
    ``fallback_ratio`` x the median, and run the mixed matmul (fallback
    tiles in bf16 against the dequantized W, the rest in fp8). ``w_k``: the
    forward's K-major W (``fp8_mixed_matmul``)."""
    x_q, s_blk = block_quantize(x, fmt, block_rows, block_cols)
    fb = fallback_mask(s_blk, fallback_ratio)
    if transpose_w:
        _check_w_k(w_k, w_q, True)
        return fp8_mixed_matmul_t(x, x_q, s_blk, fb, w_q, s_w, block_rows=block_rows,
                                  block_cols=block_cols, out_dtype=out_dtype)
    return fp8_mixed_matmul(x, x_q, s_blk, fb, w_q, s_w, block_rows=block_rows,
                            block_cols=block_cols, out_dtype=out_dtype, w_k=w_k)


KERNELS = (row_quantize, tensor_quantize, tensor_quantize_kt, block_quantize,
           fp8_matmul_dequant, fp8_matmul_dequant_t, fp8_mixed_matmul, fp8_mixed_matmul_t,
           transpose_bytes)


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
