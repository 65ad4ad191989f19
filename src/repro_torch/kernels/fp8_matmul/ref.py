"""Plain PyTorch versions of the fp8 kernels.

They follow the JAX package's ``repro/kernels/fp8_matmul/ref.py`` and
repeat the CUDA kernels' arithmetic: ``ops.py`` sends CPU tensors here,
and on the card ``chip_smoke.py`` holds each kernel against these on the
same inputs.

* The quantizers: ``q = fp8_grid_round(x / absmax)`` (one IEEE division,
  ``core/quantization.py``'s rounding), absmax floored at 1e-12, the
  exact cast to ``float8_e4m3fn`` / ``float8_e5m2``. Row-wise, tensor-wise,
  or per (block_rows x block_cols) tile; an edge tile's state is the
  absmax of its real elements, and the state has the tile grid of the
  zero-padded array, as in the JAX package.
* ``fp8_matmul_dequant``: f32 accumulation over the k-blocks of
  ``choose_blocks``' bk, in k order, then ``acc * row_scale``. The JAX
  kernel adds one f32 dot per k-block; here each k-block's sum is exact
  (a float64 product: every quantized operand lies in [-1, 1], so E4M3
  values are multiples of 2^-9 and E5M2 values of 2^-16, and every
  partial sum of a k-block of at most 4096 products is a multiple of
  2^-25 below 2^12, well inside float64's 53 bits) and is rounded once to
  f32. The JAX package's in-block f32 dot follows XLA's order, so port
  and JAX agree to a stated tolerance; the CUDA kernel (tensor cores) to
  ``matmul_bound``.
* ``fp8_mixed_matmul``: per (row tile, k tile): clean tiles
  ``(q * (s_blk * s_w)) . w_q``, fallback tiles ``bf16(x) . bf16(w_q *
  s_w)``, each tile's sum in float64 and rounded once to f32, then added
  in k order. Both the f32 scaled operand and the bf16 operands have short
  significands, so a tile's float64 sum is exact unless its products span
  more than about 18 binades.
* ``fallback_mask``: ``state > ratio * median(state)`` with the JAX
  median (the mean of the two middle values of an even count;
  ``torch.median`` returns the lower one).

W is (K, M), or (M, K) for the ``transpose_w`` (``_t``) forms, which
contract over W's second dim (the input gradient, against the forward's
fp8 W).

The CUDA matmuls run on the tensor cores (fp8 and bf16 wgmma), which add
each window's products in another order and to a width short of f32, so
kernel and plain version agree to ``matmul_bound`` per output, not bit for
bit; inputs whose window sums are exact at that width give the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import FP8_DTYPES, fp8_grid_round

EPS = 1e-12

# the JAX package's VMEM budget (repro/kernels/switchback/ops.py): it sets
# the k-split of the f32 accumulation, so both packages add the same
# k-blocks in the same order
VMEM_BUDGET_BYTES = 8 * 1024 * 1024


def choose_blocks(B: int, K: int, M: int) -> tuple[int, int, int]:
    """The JAX package's static tile choice (bb, bk, bm): the largest
    tiles whose double-buffered working set fits VMEM_BUDGET_BYTES, bk
    grown first. Only bk matters here: ``min(bk, K)`` is the k-block of
    ``fp8_matmul_dequant``."""
    def fits(bb, bk, bm):
        return 2 * bb * bk + 2 * bk * bm + bb * bm * 4 + bb * bm * 2 <= VMEM_BUDGET_BYTES

    bb, bm, bk = 256, 256, 512
    while bk * 2 <= min(K, 4096) and fits(bb, bk * 2, bm):
        bk *= 2
    while bm * 2 <= min(M, 1024) and fits(bb, bk, bm * 2):
        bm *= 2
    while bb * 2 <= min(B, 1024) and fits(bb * 2, bk, bm):
        bb *= 2
    return bb, bk, bm


def block_k(B: int, K: int, M: int) -> int:
    """The k-block of ``fp8_matmul_dequant`` at these shapes."""
    return min(choose_blocks(B, K, M)[1], K)


def check_fmt(fmt: str):
    if fmt not in FP8_DTYPES:
        raise ValueError(f"unknown fp8 format {fmt!r}; expected {tuple(FP8_DTYPES)}")


def cast(x: torch.Tensor, absmax: torch.Tensor, fmt: str) -> torch.Tensor:
    """q = fp8(x / absmax), absmax broadcast against x."""
    return fp8_grid_round(x.float() / absmax, fmt).to(FP8_DTYPES[fmt])


def row_quantize(x: torch.Tensor, fmt: str = "e4m3"):
    """x (B, K) -> (q fp8 (B, K), state f32 (B, 1))."""
    check_fmt(fmt)
    am = x.float().abs().amax(dim=-1, keepdim=True).clamp_min(EPS)
    return cast(x, am, fmt), am


def tensor_quantize(x: torch.Tensor, fmt: str = "e4m3"):
    """x (R, C) -> (q fp8 (R, C), state f32 (1, 1))."""
    check_fmt(fmt)
    am = x.float().abs().amax().clamp_min(EPS).reshape(1, 1)
    return cast(x, am, fmt), am


def tile_grid(R: int, C: int, block_rows: int, block_cols: int):
    """(br, bc, nbr, nbc): the tile of ``block_quantize`` (each side at most
    the array's) and the tile grid of the zero-padded array."""
    br, bc = min(block_rows, R), min(block_cols, C)
    return br, bc, -(-R // br), -(-C // bc)


def block_absmax(x: torch.Tensor, block_rows: int, block_cols: int) -> torch.Tensor:
    """(R, C) -> (nbr, nbc) per-tile absmax of |x| in f32 (zero padding
    cannot raise a tile's absmax), not floored."""
    R, C = x.shape
    br, bc, nbr, nbc = tile_grid(R, C, block_rows, block_cols)
    xp = torch.nn.functional.pad(x.float().abs(), (0, nbc * bc - C, 0, nbr * br - R))
    return xp.reshape(nbr, br, nbc, bc).amax(dim=(1, 3))


def expand_tiles(t: torch.Tensor, R: int, C: int, br: int, bc: int) -> torch.Tensor:
    """A per-tile (nbr, nbc) tensor broadcast to every element of (R, C)."""
    return t.repeat_interleave(br, 0)[:R].repeat_interleave(bc, 1)[:, :C]


def block_quantize(x: torch.Tensor, fmt: str = "e4m3", block_rows: int = 128,
                   block_cols: int = 128):
    """x (R, C) -> (q fp8 (R, C), state f32 (⌈R/br⌉, ⌈C/bc⌉)): one scale
    per tile."""
    check_fmt(fmt)
    R, C = x.shape
    br, bc, _, _ = tile_grid(R, C, block_rows, block_cols)
    am = block_absmax(x, br, bc).clamp_min(EPS)
    return cast(x, expand_tiles(am, R, C, br, bc), fmt), am


def fallback_mask(state: torch.Tensor, ratio: float) -> torch.Tensor:
    """1.0 where a tile's absmax exceeds ``ratio`` x the median tile absmax,
    else 0.0, f32 of ``state``'s shape: the JAX median, ``(lo + hi) * 0.5``
    of the two middle values (one value twice for an odd count), and the
    comparison in f32. A plain op on the tiny state, on either device."""
    s = state.float().flatten().sort().values
    n = s.numel()
    med = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return (state > torch.full_like(med, ratio) * med).float()


def _w_block(w: torch.Tensor, k0: int, k1: int, transpose_w: bool) -> torch.Tensor:
    """W's rows k0:k1 of the contraction as a (k, M) block."""
    return w[:, k0:k1].t() if transpose_w else w[k0:k1]


def _block_sums(a: torch.Tensor, w: torch.Tensor, bk: int, transpose_w: bool):
    """Per k-block of width bk: the block's product a[:, k] . w[k, :] in
    float64, rounded once to f32."""
    K = a.shape[1]
    for k0 in range(0, K, bk):
        k1 = min(k0 + bk, K)
        yield (a[:, k0:k1].double() @ _w_block(w, k0, k1, transpose_w).double()).float()


def fp8_matmul_dequant(x_q: torch.Tensor, w_q: torch.Tensor, row_scale: torch.Tensor, *,
                       transpose_w: bool = False, out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = (sum over the k-blocks of ``block_k``, in k order, of each
    block's exactly summed product rounded to f32) * row_scale, rounded to
    ``out_dtype``. x_q (B, K) fp8; w_q (K, M) fp8, or (M, K) with
    ``transpose_w``; row_scale (B, 1) f32 (the prefolded s_x * s_w)."""
    B, K = x_q.shape
    M = w_q.shape[0] if transpose_w else w_q.shape[1]
    acc = torch.zeros((B, M), dtype=torch.float32, device=x_q.device)
    for d in _block_sums(x_q.float(), w_q.float(), block_k(B, K, M), transpose_w):
        acc = acc + d
    return (acc * row_scale).to(out_dtype)


def fp8_mixed_matmul(x16: torch.Tensor, x_q: torch.Tensor, s_blk: torch.Tensor,
                     fb_blk: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, *,
                     block_rows: int, block_cols: int, transpose_w: bool = False,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """The mixed fp8/bf16 matmul over ``block_quantize``'s tiles: x16 (B, K)
    the unquantized operand, x_q (B, K) fp8 with per-tile scales s_blk and
    fallback mask fb_blk (nbr, nbk); w_q (K, M) fp8 ((M, K) with
    ``transpose_w``) with tensor scale s_w (1, 1). Per (row tile, k tile):
    clean tiles ``(q * (s_blk * s_w)) . w_q``, fallback tiles
    ``bf16(x16) . bf16(w_q * s_w)``; each tile's float64 sum rounded once
    to f32 and added in k order; then rounded to ``out_dtype``."""
    B, K = x_q.shape
    M = w_q.shape[0] if transpose_w else w_q.shape[1]
    br, bk, _, _ = tile_grid(B, K, block_rows, block_cols)
    sw = s_w.reshape(())
    xs = x_q.float() * expand_tiles(s_blk * sw, B, K, br, bk)
    xb = x16.to(torch.bfloat16).float()
    w8 = w_q.float()
    w16 = (w8 * sw).to(torch.bfloat16).float()
    fb_rows = fb_blk.repeat_interleave(br, 0)[:B] != 0          # (B, nbk)
    acc = torch.zeros((B, M), dtype=torch.float32, device=x_q.device)
    clean = _block_sums(xs, w8, bk, transpose_w)
    fallback = _block_sums(xb, w16, bk, transpose_w)
    for kt, (d8, d16) in enumerate(zip(clean, fallback)):
        acc = acc + torch.where(fb_rows[:, kt:kt + 1], d16, d8)
    return acc.to(out_dtype)


# How far the tensor-core kernels may lie from these plain versions
# (``matmul_bound``). How a wgmma step adds (``wgmma_model.py``, fitted to
# an H100's outputs; chip_smoke.py's accumulator probe measures the widths):
# its addends (the step's products and, after a window's first step, the
# fragment it accumulates into) are aligned to E, the largest of the
# products' exponent sums and the fragment's exponent, and each truncated
# toward zero to a multiple of 2^(E - t) (fp8 t 13; bf16 25); their sum is
# then truncated to t bits below its own leading bit (fp8 13; bf16 23, f32).
# 2^E is at most the largest addend's magnitude, a subnormal operand
# counted as its format's least normal value (``_mag``), so each addend and
# each step's sum loses less than 2^-ACC_BITS of the window's sum of
# magnitudes (ACC_BITS the narrower width of each kind). A window promoted
# into f32 is off by less than ADDENDS 2^-ACC_BITS times that sum: fp8's
# k32 steps truncate 128 products, 3 fragments and 4 sums, bf16's k16
# steps 128 products, 7 fragments and 8 sums. F32_SLACK covers the f32
# roundings both sides add (the windows' and the k-blocks' additions, at
# most 256 at 2^-24 each, and fp8_mixed's scaled operand, one rounding per
# product).
ACC_BITS = {"fp8": 13, "bf16": 23}
WINDOW = 128
ADDENDS = {"fp8": WINDOW + 3 + 4, "bf16": WINDOW + 7 + 8}
F32_SLACK = 2.0 ** -16
# the least normal value of each operand format
MIN_NORMAL = {torch.float8_e4m3fn: 2.0 ** -6, torch.float8_e5m2: 2.0 ** -14,
              torch.bfloat16: 2.0 ** -126}


def _coef(kind: str) -> float:
    return ADDENDS[kind] * 2.0 ** -ACC_BITS[kind] + F32_SLACK


def _mag(t: torch.Tensor) -> torch.Tensor:
    """|t| in float64, a nonzero subnormal raised to its format's least
    normal value (the magnitude a wgmma step aligns it by)."""
    a, m = t.double().abs(), MIN_NORMAL[t.dtype]
    return torch.where((a > 0) & (a < m), m, a)


def ulp(y: torch.Tensor, dtype) -> torch.Tensor:
    """One unit in the last place of ``dtype`` at |y| (float64), the
    subnormal spacing below the normal range."""
    bits = {torch.float32: 24, torch.bfloat16: 8}[dtype]
    a = y.double().abs().clamp_min(torch.finfo(dtype).tiny)
    return torch.ldexp(torch.ones_like(a), torch.frexp(a).exponent - bits)


def matmul_bound(y_plain: torch.Tensor, x_q: torch.Tensor, w_q: torch.Tensor,
                 row_scale: torch.Tensor | None = None, *, transpose_w: bool = False,
                 x16: torch.Tensor | None = None, s_blk: torch.Tensor | None = None,
                 fb_blk: torch.Tensor | None = None, s_w: torch.Tensor | None = None,
                 block_rows: int = 128, block_cols: int = 128) -> torch.Tensor:
    """Per output (float64, y_plain's shape), the most a CUDA matmul's
    output may differ from the plain version's ``y_plain`` on the same
    inputs. ``fp8_matmul_dequant`` (``row_scale`` given): |row_scale| *
    c * 2^-t * (|x_q| @ |w_q|) + 1 ulp of the output type. ``fp8_mixed_matmul``
    (``x16``, ``s_blk``, ``fb_blk``, ``s_w`` given): the same sum over the
    tiles, clean tiles |x_q * s_blk * s_w| @ |w_q| at the fp8 width,
    fallback tiles |bf16(x16)| @ |bf16(w_q * s_w)| at the bf16 width; c
    2^-t is ``_coef``: ADDENDS 2^-ACC_BITS + F32_SLACK; |.| of an operand
    is ``_mag``."""
    B, K = x_q.shape
    w8 = _mag(w_q)
    w8 = w8.t() if transpose_w else w8
    if s_blk is None:
        terms = _coef("fp8") * (_mag(x_q) @ w8) * row_scale.double().abs()
    else:
        br, bk, _, _ = tile_grid(B, K, block_rows, block_cols)
        sw = s_w.reshape(())
        fb = expand_tiles(fb_blk, B, K, br, bk) != 0
        a8 = _mag(x_q) * expand_tiles(s_blk.double() * sw.double(), B, K, br, bk).abs()
        a16 = _mag(x16.to(torch.bfloat16))
        w16 = _mag((w_q.float() * sw).to(torch.bfloat16))
        w16 = w16.t() if transpose_w else w16
        terms = (_coef("fp8") * (torch.where(fb, 0.0, a8) @ w8)
                 + _coef("bf16") * (torch.where(fb, a16, 0.0) @ w16))
    return terms + ulp(y_plain.double().abs() + terms, y_plain.dtype)


# Entries on which the tensor cores' window sums are exact: the product of
# two is a multiple of 2^-6 of magnitude at most 1, so a window of WINDOW
# products sums under 2^(-6 + ACC_BITS["fp8"] + 1) in |.| and no addend
# loses a bit; the f32 sums over K <= 2^17 are exact too. The kernels give
# these plain versions' bits on them (chip_smoke.py phase 19, the cuda
# tests), which catches indexing and layout faults a tolerance would hide.
EXACT_ENTRIES = (0.0, 0.125, 0.25, 0.5, 1.0)


def exact_entries(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """f32 entries drawn uniformly from +-EXACT_ENTRIES."""
    vals = torch.tensor(EXACT_ENTRIES + tuple(-v for v in EXACT_ENTRIES[1:]), device=device)
    return vals[torch.randint(len(vals), shape, generator=generator, device=device)]
