"""A plain torch model of the fp8 matmul kernels' tensor-core arithmetic.

The CUDA matmuls (``csrc/fp8_matmul.cu``) add on wgmma, whose steps keep
fewer bits than f32. How a step adds was fitted to the card's outputs (an
H100, single windows of random operands, no output off) and is checked
there by chip_smoke.py's accumulator probe and phase 19:

* a step's addends are its products (32 of fp8, 16 of bf16) and, after a
  window's first step, the fragment it accumulates into. They are aligned
  to E, the largest of the products' exponent sums e_a + e_w (each
  operand's exponent, a subnormal's taken as its format's least normal
  one) and the fragment's exponent, and each is truncated toward zero to
  a multiple of 2^(E - ALIGN_BITS); the truncated addends are summed, and
  the sum is truncated toward zero to SUM_BITS bits below its own leading
  bit (fp8: 13 and 13, so a step's result keeps 14 significant bits; bf16:
  25 and 23, the sum cut to f32);
* a window (at most ``ref.WINDOW`` of the contraction, inside a k-block or
  a scale tile) is one chain of steps into a fresh fragment, which the
  CUDA cores promote into the f32 accumulator in k order:
  ``fp8_matmul_dequant`` adds it, ``fp8_mixed_matmul`` takes
  fma(fragment, s_blk * s_w, acc) on clean tiles and adds the bf16
  fragment on fallback tiles (each one rounding);
* the epilogue: y = acc * row_scale (dequant only), rounded once to the
  output type.

``dequant_rows`` and ``mixed_rows`` compute the kernels' outputs for the
chosen rows that way, step by step, and ``wgrad_rows`` those of
``kernels/switchback``'s ``wgrad_bf16`` (bf16 steps that read both
operands MN-major; the probe reads that form too). They form every
product, so they are slow and meant for checks at a few rows: on the card
the kernels give their bits (chip_smoke.py phases 19 and 27, the cuda
tests), which holds the kernels' arithmetic where ``ref.matmul_bound`` and
``switchback.ref.wgrad_bound``, worst cases, are loose.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fp8_matmul import ref as _ref
from repro_torch.kernels.switchback.ref import WGRAD_WINDOW

# products per wgmma step; the bits an addend keeps below the step's
# alignment exponent, and the sum below its own leading bit
STEP = {"fp8": 32, "bf16": 16}
ALIGN_BITS = {"fp8": 13, "bf16": 25}
SUM_BITS = {"fp8": 13, "bf16": 23}
# the least normal exponent of each operand format
EMIN = {torch.float8_e4m3fn: -6, torch.float8_e5m2: -14, torch.bfloat16: -126}
_NONE = -1 << 20                      # the exponent of a zero: below every other


def _exponent(x: torch.Tensor, emin: int | None = None) -> torch.Tensor:
    """floor(log2 |x|) of float64 values (at least ``emin`` when given),
    _NONE where x is 0."""
    e = torch.frexp(torch.where(x != 0, x, torch.ones_like(x))).exponent - 1
    e = e if emin is None else e.clamp_min(emin)
    return torch.where(x != 0, e, torch.full_like(e, _NONE))


def _truncate(x: torch.Tensor, e: torch.Tensor, bits: int) -> torch.Tensor:
    """x toward zero to a multiple of 2^(e - bits) (x where e is _NONE)."""
    q = torch.ldexp(torch.ones_like(x), torch.where(e == _NONE, 0, e) - bits)
    return torch.trunc(x / q) * q


def _step(a: torch.Tensor, w: torch.Tensor, ea: torch.Tensor, ew: torch.Tensor,
          c: torch.Tensor | None, kind: str) -> torch.Tensor:
    """One wgmma step: operands a (R, 1, n), w (1, M, n) float64 with their
    exponents ``ea``, ``ew``, and the fragment ``c`` (R, M) before it (None
    on a window's first step) -> the fragment after it, f32."""
    p = a * w
    e = torch.where(p != 0, ea + ew, _NONE).amax(-1)
    if c is not None:
        c = c.double()
        e = torch.maximum(e, _exponent(c))
    s = _truncate(p, e[..., None], ALIGN_BITS[kind]).sum(-1)
    if c is not None:
        s = s + _truncate(c, e, ALIGN_BITS[kind])
    return _truncate(s, _exponent(s), SUM_BITS[kind]).float()


def _window(a: torch.Tensor, w: torch.Tensor, ea: torch.Tensor, ew: torch.Tensor, k0: int,
            k1: int, kind: str) -> torch.Tensor:
    """The fragment of contraction [k0, k1): a (R, K), w (M, K) float64 with
    their exponents -> (R, M) f32, one chain of steps."""
    frag = None
    for s0 in range(k0, k1, STEP[kind]):
        sl = slice(s0, min(s0 + STEP[kind], k1))
        frag = _step(a[:, None, sl], w[None, :, sl], ea[:, None, sl], ew[None, :, sl], frag, kind)
    return frag


def _operand(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An operand as float64 and its exponents, as a step aligns them."""
    v = t.double()
    return v, _exponent(v, EMIN[t.dtype])


def window_sum(a: torch.Tensor, w: torch.Tensor, kind: str) -> torch.Tensor:
    """One window's fragment: a (R, k) . w (M, k)^T in the operands' own
    dtypes (fp8, or bf16 for ``kind`` "bf16"), k at most ``ref.WINDOW``
    -> (R, M) f32."""
    (a, ea), (w, ew) = _operand(a), _operand(w)
    return _window(a, w, ea, ew, 0, a.shape[1], kind)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c rounded once, to nearest even (``__fmaf_rn``)."""
    p = a.double() * b.double()                     # exact: 24 + 24 bits
    cd = c.double()
    s = p + cd
    v = s - p
    e = (p - (s - v)) + (cd - v)                    # s + e == p + c exactly
    r = s.float()
    rd = r.double()
    other = torch.nextafter(r, torch.where(rd > s, -torch.inf, torch.inf).float())
    # s halfway between two floats: the exact value lies on e's side of it
    fix = ((rd + other.double()) * 0.5 == s) & ((other.double() - s) * e > 0)
    return torch.where(fix, other, r)


def dequant_rows(x_q: torch.Tensor, w_q: torch.Tensor, row_scale: torch.Tensor,
                 rows: torch.Tensor, *, transpose_w: bool = False,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """Rows ``rows`` of what the CUDA ``fp8_matmul_dequant`` (``_t`` with
    ``transpose_w``) gives: windows inside the plain version's k-blocks."""
    B, K = x_q.shape
    a, ea = _operand(x_q[rows])
    w, ew = _operand(w_q if transpose_w else w_q.t())
    bk = _ref.block_k(B, K, w.shape[0])
    acc = torch.zeros((a.shape[0], w.shape[0]), dtype=torch.float32, device=a.device)
    for kb in range(0, K, bk):
        ke = min(kb + bk, K)
        for k0 in range(kb, ke, _ref.WINDOW):
            acc = acc + _window(a, w, ea, ew, k0, min(k0 + _ref.WINDOW, ke), "fp8")
    return (acc * row_scale[rows].float()).to(out_dtype)


def mixed_rows(x16: torch.Tensor, x_q: torch.Tensor, s_blk: torch.Tensor, fb_blk: torch.Tensor,
               w_q: torch.Tensor, s_w: torch.Tensor, rows: torch.Tensor, *,
               block_rows: int = 128, block_cols: int = 128, transpose_w: bool = False,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """Rows ``rows`` of what the CUDA ``fp8_mixed_matmul`` (``_t`` with
    ``transpose_w``) gives: windows inside the scale tiles, fp8 fragments
    scaled by fma on clean tiles, bf16(x16) against bf16(w * s_w) on
    fallback tiles."""
    B, K = x_q.shape
    br, bk, _, nbk = _ref.tile_grid(B, K, block_rows, block_cols)
    w8 = w_q if transpose_w else w_q.t()
    sw = s_w.reshape(()).float()
    a8, ea8 = _operand(x_q[rows])
    a16, ea16 = _operand(x16[rows].to(torch.bfloat16))
    w16, ew16 = _operand((w8.float() * sw).to(torch.bfloat16))
    w8, ew8 = _operand(w8)
    tr = rows // br
    acc = torch.zeros((a8.shape[0], w8.shape[0]), dtype=torch.float32, device=a8.device)
    for kt in range(nbk):
        kb, ke = kt * bk, min(kt * bk + bk, K)
        sc = (s_blk[tr, kt].float() * sw)[:, None].expand_as(acc)
        fb = fb_blk[tr, kt] != 0
        back = fb.nonzero()[:, 0]
        for k0 in range(kb, ke, _ref.WINDOW):
            k1 = min(k0 + _ref.WINDOW, ke)
            part = _window(a8, w8, ea8, ew8, k0, k1, "fp8")
            acc = torch.where(fb[:, None], acc, _fma_f32(part, sc, acc))
            if len(back):
                acc[back] = acc[back] + _window(a16[back], w16, ea16[back], ew16, k0, k1, "bf16")
    return acc.to(out_dtype)


def wgrad_rows(x: torch.Tensor, g: torch.Tensor, rows) -> torch.Tensor:
    """Rows ``rows`` of what the CUDA ``wgrad_bf16`` gives: dw = xᵀ g,
    x (B, K) and g (B, M) rounded to bf16, as (len(rows), M) f32: each
    window of ``WGRAD_WINDOW`` rows of B one chain of bf16 steps into a
    fresh fragment, the fragments added into an f32 accumulator in B
    order."""
    a, ea = _operand(x.to(torch.bfloat16)[:, rows].t())
    w, ew = _operand(g.to(torch.bfloat16).t())
    B = x.shape[0]
    acc = torch.zeros((a.shape[0], w.shape[0]), dtype=torch.float32, device=a.device)
    for k0 in range(0, B, WGRAD_WINDOW):
        acc = acc + _window(a, w, ea, ew, k0, min(k0 + WGRAD_WINDOW, B), "bf16")
    return acc


def check_rows(R: int, n: int = 32) -> list[int]:
    """The rows a check holds to the model: the first and last rows of the
    first three 128-row tiles (phase 19's tie row, zero row, zero tile and
    outlier tile among them), the last rows, and ``n`` spread between."""
    picks = {0, 1, 2, 3, 127, 128, 129, 255, 256, 257, 383, 384, R // 2, R - 2, R - 1}
    picks |= {i * R // n for i in range(n)}
    return sorted(r for r in picks if 0 <= r < R)
