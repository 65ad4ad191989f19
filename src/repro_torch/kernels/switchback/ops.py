"""Public wrappers for the SwitchBack kernels, forward, input gradient and
the 16-bit weight gradient: dispatch by device.

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
The fused forward and dgrad count one launch a call: at ``SWAP_ROWS`` rows
or fewer that is one CUDA kernel, above it two (x's row-quantize pass into
the wrapper's workspace, then the int8 GEMM).

The ``*_batched`` wrappers are the expert-batched forms of
``tensor_quantize`` and the fused pair (the JAX package's kernels under
``jax.vmap`` over experts, ``repro/models/moe.py``'s ``expert_linear``):
one wrapper launch for all E experts, each expert's arithmetic its 2-D
call's, so they are bit-equal to a loop of the 2-D wrappers. The fused
pair's batched form takes any contraction (the JAX split at
``FUSED_MAX_CONTRACT`` picks between two computations with the same bits).

``wgrad_bf16`` is the JAX package's op entry point of the same name; no
serve or train path calls it (the training path's Ẇ is one cuBLAS GEMM,
``core/switchback.wgrad_16bit``, as the JAX package's is XLA's
``dot_general``).
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

# At most this many rows, the fused forward and dgrad quantize x inside
# their one launch (the kernels' swapped decode form, N = 16); above it the
# kernels take a workspace for x's int8 rows and absmax from the wrapper.
SWAP_ROWS = 16

_FLOAT_TYPES = (torch.float32, torch.bfloat16)
# tensor_quantize's partial maxima, one a block: the most blocks its
# launcher takes (kMaxPartials, kernels/csrc/tensor_absmax.cuh)
MAX_PARTIALS = 1024


# the batched tensor quantizer's partial maxima, one a block: the most
# blocks it gives one expert (kBatchedPartials, kernels/csrc/tensor_absmax.cuh)
BATCHED_PARTIALS = 64


LAUNCHES = dict.fromkeys((
    "tensor_quantize", "fused_switchback_fwd", "row_quantize", "col_quantize",
    "int8_matmul_dequant", "int8_matmul_dequant_colscale", "fused_switchback_dgrad",
    "int8_matmul_dequant_t", "int8_matmul_dequant_colscale_t", "wgrad_bf16",
    "tensor_quantize_batched", "fused_switchback_fwd_batched",
    "fused_switchback_dgrad_batched"), 0)


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


def _tensor(x: torch.Tensor, drop=None):
    """One launch of the tensor quantizer on a CUDA x (its two passes
    past the registers): the partials allocated here, the stream's barrier
    workspace; with ``drop``, the control fault's entry point."""
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    partial = torch.empty((MAX_PARTIALS,), dtype=torch.float32, device=x.device)
    st = _b.stream(x)
    args = (x.data_ptr(), int(x.dtype == torch.bfloat16), x.numel(), partial.data_ptr(),
            _b.grid_barrier(x.device, st).data_ptr(), q.data_ptr(), s.data_ptr())
    if drop is None:
        _b.launch(_lib().sb_tensor_quantize, *args, st)
    else:
        _b.launch(_lib().sb_tensor_quantize_drop, *args, drop, st)
    return q, s


def tensor_quantize(x: torch.Tensor):
    """x (R, C) f32/bf16 -> (q int8 (R, C), state f32 (1, 1))  (Eq. 2)."""
    _b.need(x, "x", _FLOAT_TYPES, 2)
    if _b.on_cpu(x):
        return _ref.tensor_quantize(x)
    out = _tensor(x)
    LAUNCHES["tensor_quantize"] += 1
    return out


def tensor_quantize_drop(x: torch.Tensor, drop: int):
    """The checks' control fault: ``tensor_quantize`` with block ``drop``'s
    partial maximum left out of the absmax. CUDA tensors only, not a path's
    entry point and not counted in ``LAUNCHES``."""
    _b.need(x, "x", _FLOAT_TYPES, 2)
    if _b.on_cpu(x):
        raise ValueError("tensor_quantize_drop launches the kernel: x must lie on the card")
    return _tensor(x, drop)


def tensor_quantize_plan(x: torch.Tensor) -> dict:
    """The launch plan ``tensor_quantize`` takes for x (``build.plan``)."""
    _b.need(x, "x", _FLOAT_TYPES, 2)
    return _b.plan(_lib().sb_tensor_quantize_plan, x)


def _check_weight(w_q: torch.Tensor, K: int):
    _b.need(w_q, "w_q", (torch.int8,), 2)
    if w_q.shape[0] != K:
        raise ValueError(f"w_q {tuple(w_q.shape)} does not contract with K={K}")


_SPLIT: dict = {}         # (device index, M, E) -> the one-launch fused form's int32 sums


def _split_sums(device: torch.device, M: int, E: int = 1) -> torch.Tensor:
    """The fused pair's K-split workspace at SWAP_ROWS rows or fewer for
    an output width M, E experts deep: per expert int32 s32 sums
    (SWAP_ROWS, M), then one ticket per 128-column tile. Zero when made,
    and every launch leaves it zero (the last block of a tile takes the
    sums back out), so one buffer serves every launch in stream order,
    CUDA-graph replays included. Kept for the process's life, since a
    captured graph holds its address."""
    key = (device.index, M, E)
    if key not in _SPLIT:
        _SPLIT[key] = torch.zeros(E * (SWAP_ROWS * M + -(-M // 128)), dtype=torch.int32,
                                  device=device)
    return _SPLIT[key]


def _fused(entry, name, x, w_q, s_w, M):
    """Launch one of the fused entry points on x (B, K), or on x (E, B, K)
    for the batched ones, and count it once under ``name``. Above
    SWAP_ROWS rows (an expert) the kernels first quantize x into a
    workspace allocated here (int8 x.shape and the f32 absmax a row); at
    SWAP_ROWS or fewer they split K over blocks into ``_split_sums``."""
    batched = x.dim() == 3
    E, B, K = x.shape if batched else (1, *x.shape)
    y = torch.empty(x.shape[:-1] + (M,), dtype=x.dtype, device=x.device)
    # held until the launch is queued: a workspace freed before it could be
    # handed out again, in part, to the other
    if B > SWAP_ROWS:
        work = (torch.empty(x.shape, dtype=torch.int8, device=x.device),
                torch.empty((E * B,), dtype=torch.float32, device=x.device))
        ptrs = [t.data_ptr() for t in work] + [None]
    else:
        ptrs = [None, None, _split_sums(x.device, M, E).data_ptr()]
    dims = (E, B, K, M) if batched else (B, K, M)
    _b.launch(entry, x.data_ptr(), int(x.dtype == torch.bfloat16), w_q.data_ptr(),
              s_w.data_ptr(), y.data_ptr(), *ptrs, *dims, _b.stream(x))
    LAUNCHES[name] += 1
    return y


def fused_switchback_fwd(x: torch.Tensor, w_q: torch.Tensor,
                         s_w: torch.Tensor) -> torch.Tensor:
    """Row-quantize x and run the int8 matmul: x (B, K) f32/bf16, w_q (K, M)
    int8, s_w (1, 1) f32 -> (B, M) in x's dtype."""
    _b.need(x, "x", _FLOAT_TYPES, 2)
    _check_weight(w_q, x.shape[1])
    _b.need(s_w, "s_w", (torch.float32,), 2)
    if s_w.numel() != 1:
        raise ValueError(f"s_w must hold one value, got shape {tuple(s_w.shape)}")
    if _b.on_cpu(x, w_q, s_w):
        return _ref.fused_switchback_fwd(x, w_q, s_w)
    return _fused(_lib().sb_fused_switchback_fwd, "fused_switchback_fwd", x, w_q, s_w,
                  w_q.shape[1])


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
    """Input gradient, g row-quantized for the int8 matmul as the
    forward quantizes x: g (B, M) f32/bf16, w_q (N, M) int8 as the forward quantized it,
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
    return _fused(_lib().sb_fused_switchback_dgrad, "fused_switchback_dgrad", g, w_q, s_w,
                  w_q.shape[0])


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


def wgrad_bf16(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Ẇ = xᵀ g: x (B, K) and g (B, M) of any float dtype, rounded to bf16
    on entry as the JAX op does, -> (K, M) f32. The plain version sums each
    output's B products in order in f32; the kernel on bf16 wgmma, in
    windows of ``ref.WGRAD_WINDOW`` rows, within ``ref.wgrad_bound`` of it."""
    for t, name in ((x, "x"), (g, "g")):
        if not t.is_floating_point():
            raise TypeError(f"{name}: dtype {t.dtype} is not a float type")
        if t.dim() != 2:
            raise ValueError(f"{name}: expected 2 dims, got shape {tuple(t.shape)}")
    if x.shape[0] != g.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} differ in rows")
    if _b.on_cpu(x, g):
        return _ref.wgrad_bf16(x, g)
    xb = x.to(torch.bfloat16).contiguous()
    gb = g.to(torch.bfloat16).contiguous()
    (B, K), M = xb.shape, gb.shape[1]
    dw = torch.empty((K, M), dtype=torch.float32, device=x.device)
    _b.launch(_lib().sb_wgrad_bf16, xb.data_ptr(), gb.data_ptr(), dw.data_ptr(), B, K, M,
              _b.stream(x))
    LAUNCHES["wgrad_bf16"] += 1
    return dw


def tensor_quantize_batched(x: torch.Tensor):
    """x (E, R, C) f32/bf16 -> (q int8 (E, R, C), state f32 (E, 1, 1)): one
    absmax and scale per expert (Eq. 2 an expert). On the card one wrapper
    launch (the two passes of ``kernels/csrc/tensor_absmax.cuh`` on a grid
    one expert deep)."""
    _b.need(x, "x", _FLOAT_TYPES, 3)
    if _b.on_cpu(x):
        return _ref.tensor_quantize_batched(x)
    E = x.shape[0]
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((E, 1, 1), dtype=torch.float32, device=x.device)
    partial = torch.empty((E * BATCHED_PARTIALS,), dtype=torch.float32, device=x.device)
    _b.launch(_lib().sb_tensor_quantize_batched, x.data_ptr(), int(x.dtype == torch.bfloat16),
              x[0].numel(), E, partial.data_ptr(), q.data_ptr(), s.data_ptr(), _b.stream(x))
    LAUNCHES["tensor_quantize_batched"] += 1
    return q, s


def _check_batched(x, w_q, s_w, contract_dim: int):
    """x (E, B, K) against w_q (E, ., .) contracted over its ``contract_dim``
    and s_w (E, 1, 1)."""
    _b.need(x, "x", _FLOAT_TYPES, 3)
    _b.need(w_q, "w_q", (torch.int8,), 3)
    _b.need(s_w, "s_w", (torch.float32,), 3)
    E = x.shape[0]
    if w_q.shape[0] != E or w_q.shape[contract_dim] != x.shape[2]:
        raise ValueError(f"w_q {tuple(w_q.shape)} does not contract with x {tuple(x.shape)}")
    if tuple(s_w.shape) != (E, 1, 1):
        raise ValueError(f"s_w {tuple(s_w.shape)} != {(E, 1, 1)}")


def fused_switchback_fwd_batched(x: torch.Tensor, w_q: torch.Tensor,
                                 s_w: torch.Tensor) -> torch.Tensor:
    """``fused_switchback_fwd`` an expert: x (E, B, K) f32/bf16, w_q (E, K,
    M) int8, s_w (E, 1, 1) f32 -> (E, B, M) in x's dtype."""
    _check_batched(x, w_q, s_w, 1)
    if _b.on_cpu(x, w_q, s_w):
        return _ref.fused_switchback_fwd_batched(x, w_q, s_w)
    return _fused(_lib().sb_fused_switchback_fwd_batched, "fused_switchback_fwd_batched",
                  x, w_q, s_w, w_q.shape[2])


def fused_switchback_dgrad_batched(g: torch.Tensor, w_q: torch.Tensor,
                                   s_w: torch.Tensor) -> torch.Tensor:
    """``fused_switchback_dgrad`` an expert: g (E, B, M) f32/bf16, w_q (E, N,
    M) int8 as the forward quantized it, s_w (E, 1, 1) f32 -> dx (E, B, N)
    in g's dtype, contracted over w_q's last dim."""
    _check_batched(g, w_q, s_w, 2)
    if _b.on_cpu(g, w_q, s_w):
        return _ref.fused_switchback_dgrad_batched(g, w_q, s_w)
    return _fused(_lib().sb_fused_switchback_dgrad_batched, "fused_switchback_dgrad_batched",
                  g, w_q, s_w, w_q.shape[1])


KERNELS = (tensor_quantize, fused_switchback_fwd, row_quantize, col_quantize,
           int8_matmul_dequant, fused_switchback_dgrad, int8_matmul_dequant_t, wgrad_bf16,
           tensor_quantize_batched, fused_switchback_fwd_batched, fused_switchback_dgrad_batched)


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
