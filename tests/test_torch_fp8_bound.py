"""The fp8 matmuls' stated tolerance, on the CPU.

The CUDA matmuls (``kernels/fp8_matmul/csrc/fp8_matmul.cu``) run on fp8 and
bf16 wgmma, whose sums keep ``ACC_BITS`` bits below their largest addend
(measured by chip_smoke.py's accumulator probe), so on the card they are
held to ``ref.matmul_bound`` instead of bit equality. Here, without a card:

* ``matmul_bound`` against an independent numpy float64 computation of the
  same formula, for both matmuls, both W orientations and output types;
* the bound against a numpy model of the tensor cores (each step's
  addends aligned to the largest exponent sum and truncated, the step's
  sum truncated, windows of 128 promoted into f32) on random fp8
  operands: the model's error stays inside it;
* the exactness inputs (``ref.exact_entries``) checked in numpy to be
  exact at that width: every window sum of the model equals the exact sum,
  where random entries do not;
* the torch model of the kernels' arithmetic (``wgmma_model``), which
  the card checks hold the kernels to bit for bit: its fma rounded once,
  its f32 truncation, dequant_rows equal to the numpy model, both models
  within the bound and equal to the plain versions on exact entries;
* the plain versions still bit-equal to an independent numpy sum of each
  k-block (each tile for fp8_mixed) in float64, rounded once to f32 and
  added in k order;
* the wrappers still refusing the shapes and types they refused before.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.kernels.fp8_matmul import ops as F8
from repro_torch.kernels.fp8_matmul import ref as F8REF
from repro_torch.kernels.fp8_matmul import wgmma_model as F8TC

torch.set_num_threads(1)

OUT = {"f32": torch.float32, "bf16": torch.bfloat16}
SHAPES = [(37, 130, 70), (64, 256, 96), (130, 300, 40)]


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _operands(seed, B, K, M, transpose_w, dt=torch.float32, outliers=False):
    """x (B, K), its row-quantized fp8 and scale, W's fp8 and scale in the
    orientation asked, the input gradient's formats: E4M3 x E4M3 forward,
    E5M2 x E4M3 input gradient."""
    g = _gen(seed)
    x = torch.randn((B, K), generator=g) * torch.exp(torch.empty((B, 1)).uniform_(-3, 3,
                                                                                generator=g))
    x[min(2, B - 1)] = 0.0
    if outliers:
        x[:16, :32] *= 60.0
    w = torch.randn((M, K) if transpose_w else (K, M), generator=g) / K ** 0.5
    w_q, s_w = F8REF.tensor_quantize(w, "e4m3")
    fmt = "e5m2" if transpose_w else "e4m3"
    x = x.to(dt)
    x_q, s_x = F8REF.row_quantize(x, fmt)
    return x, x_q, s_x, w_q, s_w, fmt


def _mag_np(t: torch.Tensor) -> np.ndarray:
    """|t|, a nonzero subnormal raised to its format's least normal value."""
    m = {torch.float8_e4m3fn: 2.0 ** -6, torch.float8_e5m2: 2.0 ** -14,
         torch.bfloat16: 2.0 ** -126}[t.dtype]
    a = np.abs(_np(t.float()))
    return np.where((a > 0) & (a < m), m, a)


def _ulp_np(a: np.ndarray, bits: int, tiny: float) -> np.ndarray:
    m, e = np.frexp(np.maximum(np.abs(a), tiny))
    return np.ldexp(1.0, e - bits)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.double().numpy()


def _tiles(t: np.ndarray, B, K, br, bk) -> np.ndarray:
    return np.repeat(np.repeat(t, br, 0)[:B], bk, 1)[:, :K]


def _checkerboard(s_blk: torch.Tensor) -> torch.Tensor:
    """A fallback mask with both branches on any grid of two tiles or more."""
    i, j = torch.meshgrid(torch.arange(s_blk.shape[0]), torch.arange(s_blk.shape[1]),
                          indexing="ij")
    return ((i + j) % 2 == 1).float()


# ---------------------------------------------------------------------------
# matmul_bound against numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,K,M", SHAPES)
@pytest.mark.parametrize("transpose_w", [False, True], ids=["fwd", "dgrad"])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_dequant_bound_matches_numpy(B, K, M, transpose_w, out):
    x, x_q, s_x, w_q, s_w, _ = _operands(B + K, B, K, M, transpose_w)
    rs = s_x * s_w
    y = F8REF.fp8_matmul_dequant(x_q, w_q, rs, transpose_w=transpose_w, out_dtype=OUT[out])
    got = F8REF.matmul_bound(y, x_q, w_q, rs, transpose_w=transpose_w)
    w = _mag_np(w_q)
    w = w.T if transpose_w else w
    coef = F8REF.ADDENDS["fp8"] * 2.0 ** -F8REF.ACC_BITS["fp8"] + F8REF.F32_SLACK
    terms = coef * (_mag_np(x_q) @ w) * np.abs(_np(rs))
    bits, tiny = (24, 2.0 ** -126) if out == "f32" else (8, 2.0 ** -126)
    want = terms + _ulp_np(np.abs(_np(y.float())) + terms, bits, tiny)
    assert got.dtype == torch.float64 and tuple(got.shape) == (B, M)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("B,K,M", SHAPES)
@pytest.mark.parametrize("transpose_w", [False, True], ids=["fwd", "dgrad"])
@pytest.mark.parametrize("tiles", [(16, 32), (128, 128)], ids=["16x32", "128x128"])
def test_mixed_bound_matches_numpy(B, K, M, transpose_w, tiles):
    br, bc = tiles
    x, _, _, w_q, s_w, fmt = _operands(B * K, B, K, M, transpose_w, outliers=True)
    a_q, s_blk = F8REF.block_quantize(x, fmt, br, bc)
    fb = _checkerboard(s_blk)
    kw = dict(block_rows=br, block_cols=bc, transpose_w=transpose_w)
    y = F8REF.fp8_mixed_matmul(x, a_q, s_blk, fb, w_q, s_w, out_dtype=torch.float32, **kw)
    got = F8REF.matmul_bound(y, a_q, w_q, x16=x, s_blk=s_blk, fb_blk=fb, s_w=s_w, **kw)
    bb, bk, _, _ = F8REF.tile_grid(B, K, br, bc)
    sw = float(s_w)
    fbe = _tiles(_np(fb), B, K, bb, bk) != 0
    a8 = np.where(fbe, 0.0, _mag_np(a_q) * np.abs(_tiles(_np(s_blk) * sw, B, K, bb, bk)))
    a16 = np.where(fbe, _mag_np(x.to(torch.bfloat16)), 0.0)
    w8 = _mag_np(w_q)
    w16 = _mag_np((w_q.float() * sw).to(torch.bfloat16))
    if transpose_w:
        w8, w16 = w8.T, w16.T
    c8 = F8REF.ADDENDS["fp8"] * 2.0 ** -F8REF.ACC_BITS["fp8"] + F8REF.F32_SLACK
    c16 = F8REF.ADDENDS["bf16"] * 2.0 ** -F8REF.ACC_BITS["bf16"] + F8REF.F32_SLACK
    terms = c8 * (a8 @ w8) + c16 * (a16 @ w16)
    want = terms + _ulp_np(np.abs(_np(y)) + terms, 24, 2.0 ** -126)
    assert 0 < int(fb.sum()) < fb.numel()                     # both branches
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# a numpy model of the tensor cores' sums
# ---------------------------------------------------------------------------

_NO_EXP = -10 ** 6                                            # a zero's exponent


def _exps(v: np.ndarray, emin: int) -> np.ndarray:
    """floor(log2 |v|), at least emin, _NO_EXP where v is 0."""
    e = np.frexp(np.where(v != 0, v, 1.0))[1] - 1
    return np.where(v != 0, np.maximum(e, emin), _NO_EXP)


def _tc_sum(a, w, ea, ew, align: int, sum_bits: int, step: int, window: int = F8REF.WINDOW):
    """a (B, K) . w (M, K)^T (float64, with their exponents) as the wgmma
    steps add: per window a fresh fragment; per step of ``step`` products
    its addends (the products and, after the first step, the fragment)
    aligned to E, the largest of the products' exponent sums and the
    fragment's exponent, each truncated toward zero to a multiple of
    2^(E - align), summed, and the sum truncated toward zero to
    ``sum_bits`` bits below its leading bit; each window added into an f32
    accumulator in k order."""
    K = a.shape[1]
    acc = np.zeros((a.shape[0], w.shape[0]), dtype=np.float32)
    for w0 in range(0, K, window):
        frag = None
        for s0 in range(w0, min(w0 + window, K), step):
            sl = slice(s0, min(s0 + step, w0 + window, K))
            p = a[:, None, sl] * w[None, :, sl]
            e = np.where(p != 0, ea[:, None, sl] + ew[None, :, sl], _NO_EXP).max(axis=-1)
            if frag is not None:
                e = np.maximum(e, _exps(frag, -10 ** 5))
            q = np.ldexp(1.0, np.where(e == _NO_EXP, 0, e) - align)
            tot = (np.trunc(p / q[..., None]) * q[..., None]).sum(axis=-1)
            if frag is not None:
                tot = tot + np.trunc(frag / q) * q
            q = np.ldexp(1.0, np.where(tot != 0, _exps(tot, -10 ** 5), 0) - sum_bits)
            frag = np.trunc(tot / q) * q
        acc = (acc + frag.astype(np.float32)).astype(np.float32)
    return acc


_EMIN = {torch.float8_e4m3fn: -6, torch.float8_e5m2: -14}
_WIDTHS = {"fp8": (F8REF.ACC_BITS["fp8"], F8REF.ACC_BITS["fp8"], 32), "bf16": (25, 23, 16)}


def _tc_matmul(a_q, w_q, transpose_w, kind="fp8"):
    """a_q . W as the kind's steps add, a bf16 operand's exponents at bf16's
    least normal one."""
    a, w = _np(a_q.float()), _np(w_q.float())
    w = w if transpose_w else w.T                            # (M, K)
    ea, ew = ((_exps(v, _EMIN[t.dtype] if kind == "fp8" else -126)) for v, t in
              ((a, a_q), (w, w_q)))
    return _tc_sum(a, w, ea, ew, *_WIDTHS[kind])


def _products(a_q, w_q, transpose_w):
    a = _np(a_q.float())
    w = _np(w_q.float())
    w = w if transpose_w else w.T                            # (M, K)
    return a[:, None, :] * w[None, :, :]                      # (B, M, K), exact in f64


@pytest.mark.parametrize("B,K,M", SHAPES)
@pytest.mark.parametrize("transpose_w", [False, True], ids=["fwd", "dgrad"])
def test_bound_covers_the_truncation_model(B, K, M, transpose_w):
    _, x_q, s_x, w_q, s_w, _ = _operands(7 * B + K, B, K, M, transpose_w)
    rs = s_x * s_w
    y_model = torch.from_numpy(_tc_matmul(x_q, w_q, transpose_w)) * rs
    y = F8REF.fp8_matmul_dequant(x_q, w_q, rs, transpose_w=transpose_w, out_dtype=torch.float32)
    bnd = F8REF.matmul_bound(y, x_q, w_q, rs, transpose_w=transpose_w)
    share = ((y_model.double() - y.double()).abs() / bnd).max()
    assert float(share) <= 1.0
    assert not torch.equal(y_model, y)            # the model does truncate these inputs


@pytest.mark.parametrize("B,K,M", SHAPES + [(8, 4096, 16)])
@pytest.mark.parametrize("transpose_w", [False, True], ids=["fwd", "dgrad"])
def test_exact_entries_are_exact_at_the_probed_width(B, K, M, transpose_w):
    g = _gen(B + M)
    fmt = "e5m2" if transpose_w else "e4m3"
    a_q, _ = F8REF.row_quantize(F8REF.exact_entries((B, K), g), fmt)
    w_q, _ = F8REF.tensor_quantize(F8REF.exact_entries((M, K) if transpose_w else (K, M), g)
                                   * 0.125, "e4m3")
    p = _products(a_q, w_q, transpose_w)
    exact = p.sum(axis=-1)
    # the sufficient condition: multiples of 2^-6, window sums of |p| under
    # 2^(-6 + t + 1), the whole sum exact in f32
    assert np.all(np.ldexp(p, 6) == np.round(np.ldexp(p, 6)))
    t = F8REF.ACC_BITS["fp8"]
    for w0 in range(0, K, F8REF.WINDOW):
        assert np.abs(p[..., w0:w0 + F8REF.WINDOW]).sum(axis=-1).max() < 2.0 ** (-6 + t + 1)
    assert np.abs(p).sum(axis=-1).max() < 2.0 ** (-6 + 24)
    np.testing.assert_array_equal(_tc_matmul(a_q, w_q, transpose_w), exact)
    # the fallback tiles' bf16 product at its own widths and k16 steps
    np.testing.assert_array_equal(_tc_matmul(a_q, w_q, transpose_w, "bf16"), exact)
    # random entries at the same width are not exact: the model can tell
    _, r_q, _, rw_q, _, _ = _operands(B, B, K, M, transpose_w)
    rp = _products(r_q, rw_q, transpose_w)
    assert not np.array_equal(_tc_matmul(r_q, rw_q, transpose_w),
                              rp.sum(axis=-1).astype(np.float32))


# ---------------------------------------------------------------------------
# the torch model of the kernels' arithmetic (wgmma_model), which the card
# checks hold the kernels to bit for bit
# ---------------------------------------------------------------------------

def _f32_rn(x: Fraction) -> float:
    """An exact rational rounded once to the nearest f32, ties to even."""
    if x == 0:
        return 0.0
    sign, a = (-1.0 if x < 0 else 1.0), abs(x)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    e += 1 if Fraction(2) ** e <= a else 0                   # 2^(e-1) <= a < 2^e
    q = Fraction(2) ** (e - 24)
    n, r = divmod(a / q, 1)
    n += 1 if r > Fraction(1, 2) or (r == Fraction(1, 2) and n % 2) else 0
    return sign * float(n * q)


def test_model_fma_rounds_once():
    g = _gen(3)
    a = torch.randn(4000, generator=g) * torch.exp2(torch.randint(-30, 30, (4000,), generator=g))
    b = torch.randn(4000, generator=g)
    c = torch.randn(4000, generator=g) * torch.exp2(torch.randint(-30, 30, (4000,), generator=g))
    # c + a * b just under an f32 midpoint (1 + 2^-23 + 2^-24 - 2^-70), where
    # the f64 sum rounds onto the midpoint and then ties to even, upward
    u = 2.0 ** -23
    a = torch.cat([a, torch.tensor([1.0 + u, 1.0 + u, -(1.0 + u)])])
    b = torch.cat([b, torch.tensor([2.0 ** -24 * (1.0 - u), -2.0 ** -24 * (1.0 - u),
                                    2.0 ** -24 * (1.0 - u)])])
    c = torch.cat([c, torch.tensor([1.0 + u, -(1.0 + u), -(1.0 + u)])])
    naive = (a.double() * b.double() + c.double()).float()
    got = F8TC._fma_f32(a, b, c)
    assert got[-3:].tolist() == [1.0 + u, -(1.0 + u), -(1.0 + u)] != naive[-3:].tolist()
    want = [_f32_rn(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
            for x, y, z in zip(a, b, c)]
    assert got.dtype == torch.float32
    assert got.tolist() == want


def _one_step(pairs, fa, fw, kind, c=None):
    a = torch.tensor([[x for x, _ in pairs]], dtype=torch.float64).to(fa)
    w = torch.tensor([[y for _, y in pairs]], dtype=torch.float64).to(fw)
    (a, ea), (w, ew) = F8TC._operand(a), F8TC._operand(w)
    c = None if c is None else torch.tensor([[c]], dtype=torch.float32)
    return float(F8TC._step(a[:, None], w[None], ea[:, None], ew[None], c, kind)[0, 0])


# single steps whose results an H100 read (the accumulator probe's cases
# and single windows of constructed operands)
_E4, _BF = torch.float8_e4m3fn, torch.bfloat16
STEP_READINGS = [
    ("e4m3 2^16 + 31 x 4", [(256.0, 256.0)] + [(4.0, 1.0)] * 31, _E4, "fp8", None, 2.0 ** 16),
    ("e4m3 2^16 + 8", [(256.0, 256.0), (8.0, 1.0)], _E4, "fp8", None, 2.0 ** 16 + 8),
    ("e4m3 2^16 + 4", [(256.0, 256.0), (4.0, 1.0)], _E4, "fp8", None, 2.0 ** 16),
    ("e4m3 240 x 240 + 3", [(240.0, 240.0), (3.0, 1.0)], _E4, "fp8", None, 57600.0),
    ("e4m3 240 x 240 + 6", [(240.0, 240.0), (6.0, 1.0)], _E4, "fp8", None, 57604.0),
    ("e4m3 fragment 57600 + 4", [(4.0, 1.0)], _E4, "fp8", 57600.0, 57604.0),
    ("e4m3 2^16 - 4", [(256.0, 256.0), (-4.0, 1.0)], _E4, "fp8", None, 2.0 ** 16),
    ("bf16 1 + 15 x 2^-25", [(1.0, 1.0)] + [(2.0 ** -25, 1.0)] * 15, _BF, "bf16", None,
     1.0 + 3 * 2.0 ** -23),
    ("bf16 1 + 15 x 2^-26", [(1.0, 1.0)] + [(2.0 ** -26, 1.0)] * 15, _BF, "bf16", None, 1.0),
    ("bf16 1 - 3 x 2^-25", [(1.0, 1.0)] + [(-2.0 ** -25, 1.0)] * 3, _BF, "bf16", None,
     1.0 - 2.0 ** -23),
    ("bf16 1.9921875^2 + 15 x 2^-25", [(1.9921875, 1.9921875)] + [(2.0 ** -25, 1.0)] * 15, _BF,
     "bf16", None, 1.9921875 ** 2 + 2.0 ** -22),
]


@pytest.mark.parametrize("case", STEP_READINGS, ids=[c[0] for c in STEP_READINGS])
def test_model_step_reads_as_the_card(case):
    _, pairs, dt, kind, c, want = case
    assert _one_step(pairs, dt, dt, kind, c) == want


@pytest.mark.parametrize("B,K,M", SHAPES + [(16, 1280, 8)])
@pytest.mark.parametrize("transpose_w", [False, True], ids=["fwd", "dgrad"])
def test_model_dequant_matches_numpy_model(B, K, M, transpose_w):
    """dequant_rows against the independent numpy model, bit for bit: its
    windows inside the plain version's k-blocks, f32 out."""
    _, x_q, s_x, w_q, s_w, _ = _operands(7 * B + K, B, K, M, transpose_w)
    rs = s_x * s_w
    rows = torch.tensor(F8TC.check_rows(B))
    got = F8TC.dequant_rows(x_q, w_q, rs, rows, transpose_w=transpose_w,
                            out_dtype=torch.float32)
    bk = F8REF.block_k(B, K, M)
    acc = np.zeros((len(rows), M), dtype=np.float32)
    for k0 in range(0, K, bk):
        acc = (acc + _tc_matmul(x_q[rows, k0:k0 + bk],
                                w_q[:, k0:k0 + bk] if transpose_w else w_q[k0:k0 + bk],
                                transpose_w)).astype(np.float32)
    assert torch.equal(got, torch.from_numpy(acc) * rs[rows])
    y = F8REF.fp8_matmul_dequant(x_q, w_q, rs, transpose_w=transpose_w, out_dtype=torch.float32)
    assert not torch.equal(got, y[rows])              # the model truncates these inputs


@pytest.mark.parametrize("B,K,M", SHAPES)
@pytest.mark.parametrize("transpose_w", [False, True], ids=["fwd", "dgrad"])
@pytest.mark.parametrize("tiles", [(16, 32), (128, 128), (64, 48)], ids=["16x32", "128x128",
                                                                          "64x48"])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_model_lies_within_the_bound(B, K, M, transpose_w, tiles, out):
    """Both models within matmul_bound of the plain versions (what the
    bound claims for the kernels), with fallback tiles in a checkerboard."""
    br, bc = tiles
    x, x_q, s_x, w_q, s_w, fmt = _operands(B * M + K, B, K, M, transpose_w, outliers=True)
    rows = torch.tensor(F8TC.check_rows(B))
    rs = s_x * s_w
    y = F8REF.fp8_matmul_dequant(x_q, w_q, rs, transpose_w=transpose_w, out_dtype=OUT[out])
    got = F8TC.dequant_rows(x_q, w_q, rs, rows, transpose_w=transpose_w, out_dtype=OUT[out])
    bnd = F8REF.matmul_bound(y, x_q, w_q, rs, transpose_w=transpose_w)[rows]
    assert float(((got.double() - y[rows].double()).abs() / bnd).max()) <= 1.0
    a_q, s_blk = F8REF.block_quantize(x, fmt, br, bc)
    fb = _checkerboard(s_blk)
    kw = dict(block_rows=br, block_cols=bc, transpose_w=transpose_w)
    y = F8REF.fp8_mixed_matmul(x, a_q, s_blk, fb, w_q, s_w, out_dtype=OUT[out], **kw)
    got = F8TC.mixed_rows(x, a_q, s_blk, fb, w_q, s_w, rows, out_dtype=OUT[out], **kw)
    bnd = F8REF.matmul_bound(y, a_q, w_q, x16=x, s_blk=s_blk, fb_blk=fb, s_w=s_w, **kw)[rows]
    assert float(((got.double() - y[rows].double()).abs() / bnd).max()) <= 1.0


@pytest.mark.parametrize("B,K,M", SHAPES + [(8, 4096, 16)])
@pytest.mark.parametrize("transpose_w", [False, True], ids=["fwd", "dgrad"])
def test_model_is_the_plain_version_on_exact_entries(B, K, M, transpose_w):
    g = _gen(B + 2 * M)
    fmt = "e5m2" if transpose_w else "e4m3"
    a = F8REF.exact_entries((B, K), g)
    a_q, s_a = F8REF.row_quantize(a, fmt)
    w_q, s_w = F8REF.tensor_quantize(F8REF.exact_entries((M, K) if transpose_w else (K, M), g)
                                     * 0.125, "e4m3")
    rows = torch.tensor(F8TC.check_rows(B))
    rs = s_a * s_w
    assert torch.equal(F8TC.dequant_rows(a_q, w_q, rs, rows, transpose_w=transpose_w,
                                         out_dtype=torch.float32),
                       F8REF.fp8_matmul_dequant(a_q, w_q, rs, transpose_w=transpose_w,
                                                out_dtype=torch.float32)[rows])
    b_q, s_blk = F8REF.block_quantize(a, fmt, 128, 128)
    fb = _checkerboard(s_blk)
    kw = dict(block_rows=128, block_cols=128, transpose_w=transpose_w, out_dtype=torch.float32)
    assert torch.equal(F8TC.mixed_rows(a, b_q, s_blk, fb, w_q, s_w, rows, **kw),
                       F8REF.fp8_mixed_matmul(a, b_q, s_blk, fb, w_q, s_w, **kw)[rows])


@pytest.mark.parametrize("R", [1, 37, 130, 384, 4128])
def test_check_rows_cover_the_tiles(R):
    rows = F8TC.check_rows(R)
    assert rows == sorted(set(rows)) and rows[0] == 0 and rows[-1] == R - 1
    assert all(0 <= r < R for r in rows)
    assert {1, 2, 128, 256, 383} & set(range(R)) <= set(rows)


def test_transpose_bytes_on_the_cpu_is_the_plain_copy():
    F8.reset_launch_counts()
    w_q, _ = F8.tensor_quantize(torch.randn(37, 70), "e4m3")
    got = F8.transpose_bytes(w_q)
    assert got.dtype == torch.uint8 and torch.equal(got, w_q.view(torch.uint8).t().contiguous())
    assert F8.launch_counts()["fp8_transpose_bytes"] == 0
    with pytest.raises(TypeError):
        F8.transpose_bytes(w_q.float())


# ---------------------------------------------------------------------------
# the plain versions: exact block sums, as before
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,K,M", SHAPES + [(16, 1280, 8)])
@pytest.mark.parametrize("transpose_w", [False, True], ids=["fwd", "dgrad"])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_plain_dequant_is_the_exact_block_sum(B, K, M, transpose_w, out):
    _, x_q, s_x, w_q, s_w, _ = _operands(3 * B + M, B, K, M, transpose_w)
    rs = s_x * s_w
    y = F8REF.fp8_matmul_dequant(x_q, w_q, rs, transpose_w=transpose_w, out_dtype=OUT[out])
    p = _products(x_q, w_q, transpose_w)
    bk = F8REF.block_k(B, K, M)
    acc = np.zeros((B, M), dtype=np.float32)
    for k0 in range(0, K, bk):
        acc = (acc + p[..., k0:k0 + bk].sum(axis=-1).astype(np.float32)).astype(np.float32)
    want = torch.from_numpy((acc * _np(rs).astype(np.float32)).astype(np.float32))
    assert torch.equal(y, want.to(OUT[out]))


@pytest.mark.parametrize("B,K,M", SHAPES)
@pytest.mark.parametrize("transpose_w", [False, True], ids=["fwd", "dgrad"])
@pytest.mark.parametrize("tiles", [(16, 32), (128, 128)], ids=["16x32", "128x128"])
def test_plain_mixed_is_the_exact_tile_sum(B, K, M, transpose_w, tiles):
    br, bc = tiles
    x, _, _, w_q, s_w, fmt = _operands(5 * B + K, B, K, M, transpose_w, outliers=True)
    a_q, s_blk = F8REF.block_quantize(x, fmt, br, bc)
    fb = _checkerboard(s_blk)
    y = F8REF.fp8_mixed_matmul(x, a_q, s_blk, fb, w_q, s_w, block_rows=br, block_cols=bc,
                               transpose_w=transpose_w, out_dtype=torch.float32)
    bb, bk, _, _ = F8REF.tile_grid(B, K, br, bc)
    sw = np.float32(float(s_w))
    xs = (_np(a_q.float()).astype(np.float32)
          * _tiles(_np(s_blk).astype(np.float32) * sw, B, K, bb, bk).astype(np.float32))
    w8 = _np(w_q.float())
    w16 = _np((w_q.float() * float(s_w)).to(torch.bfloat16).float())
    xb = _np(x.to(torch.bfloat16).float())
    if not transpose_w:
        w8, w16 = w8.T, w16.T                                # (M, K)
    fbr = np.repeat(_np(fb), bb, 0)[:B] != 0
    acc = np.zeros((B, M), dtype=np.float32)
    for kt, k0 in enumerate(range(0, K, bk)):
        d8 = (xs[:, None, k0:k0 + bk].astype(np.float64) * w8[None, :, k0:k0 + bk]).sum(-1)
        d16 = (xb[:, None, k0:k0 + bk] * w16[None, :, k0:k0 + bk]).sum(-1)
        d = np.where(fbr[:, kt:kt + 1], d16, d8).astype(np.float32)
        acc = (acc + d).astype(np.float32)
    assert torch.equal(y, torch.from_numpy(acc))


# ---------------------------------------------------------------------------
# the wrappers refuse what they refused before
# ---------------------------------------------------------------------------

def _refused():
    x = torch.randn(8, 32)
    q, s = F8.row_quantize(x, "e4m3")
    wq, sw = F8.tensor_quantize(torch.randn(32, 16), "e4m3")
    bq, sb = F8.block_quantize(x, "e4m3", 4, 16)
    fb = F8.fallback_mask(sb, 8.0)
    mixed = dict(block_rows=4, block_cols=16)
    return {
        "x_q not fp8": (TypeError, lambda: F8.fp8_matmul_dequant(q.float(), wq, s * sw)),
        "w_q not fp8": (TypeError, lambda: F8.fp8_matmul_dequant(q, wq.float(), s * sw)),
        "W does not contract": (ValueError, lambda: F8.fp8_matmul_dequant(q, wq.t().contiguous(),
                                                                          s * sw)),
        "W does not contract (_t)": (ValueError, lambda: F8.fp8_matmul_dequant_t(q, wq, s * sw)),
        "row_scale shape": (ValueError, lambda: F8.fp8_matmul_dequant(q, wq, (s * sw)[:4])),
        "row_scale dtype": (TypeError, lambda: F8.fp8_matmul_dequant(q, wq, (s * sw).double())),
        "out_dtype f16": (TypeError, lambda: F8.fp8_matmul_dequant(q, wq, s * sw,
                                                                   out_dtype=torch.float16)),
        "x_q not contiguous": (ValueError, lambda: F8.fp8_matmul_dequant(
            torch.cat([q, q], 1)[:, ::2], wq, s * sw)),
        "x_q 3-d": (ValueError, lambda: F8.fp8_matmul_dequant(q[None], wq, s * sw)),
        "x16 shape": (ValueError, lambda: F8.fp8_mixed_matmul(x[:, :16], bq, sb, fb, wq, sw,
                                                              **mixed)),
        "tile grid": (ValueError, lambda: F8.fp8_mixed_matmul(x, bq, sb, fb, wq, sw)),
        "s_w two values": (ValueError, lambda: F8.fp8_mixed_matmul(
            x, bq, sb, fb, wq, torch.ones(1, 2), **mixed)),
        "fb_blk dtype": (TypeError, lambda: F8.fp8_mixed_matmul(x, bq, sb, fb.bool(), wq, sw,
                                                                **mixed)),
        "unknown format": (ValueError, lambda: F8.row_quantize(x, "e3m4")),
        "block shape": (ValueError, lambda: F8.block_quantize(x, "e4m3", 0, 16)),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_wrappers_still_refuse(case):
    err, call = _refused()[case]
    with pytest.raises(err):
        call()


def test_refused_calls_launch_nothing():
    F8.reset_launch_counts()
    for err, call in _refused().values():
        with pytest.raises(err):
            call()
    assert all(v == 0 for v in F8.launch_counts().values())
