"""The fp8 kernel modules of the port against the JAX package's, on the CPU.

On CPU tensors the port's wrappers (``kernels/fp8_matmul/ops.py``) run
their plain PyTorch versions; they are held against the JAX package's
Pallas kernels in interpret mode (``backend="pallas_interpret"``) on the
same inputs, made from a seeded numpy generator:

* ``fp8_grid_round`` (``core/quantization.py``), both formats, bit for bit
  against the JAX package's on every fp8 value in [-1, 1], every midpoint
  between neighbours (the ties), one f32 ulp either side of each, the
  whole range out to the format's max and past it, and 10^6 random
  values over many binades;
* ``row_quantize``, ``tensor_quantize`` and ``block_quantize``, both
  formats, f32 and bf16 inputs, ragged shapes and edge tiles, an all-zero
  row and an all-zero tile: the fp8 bytes and the states bit for bit;
* ``fallback_mask``: the JAX median (the mean of the two middle values of
  an even count, where ``torch.median`` takes the lower), a state exactly
  at ``ratio * median`` (not a fallback), odd and even counts;
* ``fp8_matmul_dequant`` in both W orientations (E4M3 x E4M3 forward,
  E5M2 x E4M3 input gradient), f32 and bf16 outputs: bit for bit against
  an independent numpy sum of each k-block in exact integer arithmetic
  (the plain version's claim), and within MATMUL_TOL of the JAX kernel,
  whose in-block f32 dot rounds in XLA's order;
* ``fp8_mixed_matmul`` (through ``mixed``, as the layer calls it) in both
  orientations with outlier tiles injected so that both branches run:
  within MATMUL_TOL of the JAX kernel, which it equals at the extreme
  ratios' all-fp8 and all-bf16 runs too.

The CUDA kernels run only on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold them against these plain versions there.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as JQ
from repro.kernels.fp8_matmul import ops as JF8
from repro.kernels.switchback.ops import choose_blocks as jax_choose_blocks
from repro_torch.core import quantization as Q
from repro_torch.kernels.fp8_matmul import ops as F8
from repro_torch.kernels.fp8_matmul import ref as F8REF

torch.set_num_threads(1)

FMTS = ("e4m3", "e5m2")
TORCH_FP8 = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# port vs the JAX kernels, relative to max|y|: the JAX kernel's in-block
# f32 dot rounds each partial sum (in XLA's order) where the port sums
# each block exactly and rounds once; measured up to 1.1e-7 in f32. In
# bf16 output one rounding may land one bf16 ulp apart (2^-8 of a value).
MATMUL_TOL = {"f32": 1e-6, "bf16": 2.0 ** -8}


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            return t.view(torch.uint8).numpy()
        return t.float().numpy()
    a = np.asarray(t)
    if a.dtype in (jnp.float8_e4m3fn, jnp.float8_e5m2):
        return a.view(np.uint8)
    return a.astype(np.float32)


def _same(a, b, msg=""):
    np.testing.assert_array_equal(_np(a), _np(b), err_msg=msg)


def _rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _fp8_bits(a, fmt) -> torch.Tensor:
    """A JAX fp8 array as the port's torch fp8 tensor, byte for byte."""
    return torch.from_numpy(np.asarray(a).view(np.uint8).copy()).view(TORCH_FP8[fmt])


def _grid(fmt) -> np.ndarray:
    """Every finite value of the format, ascending (both zeros once)."""
    v = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(TORCH_FP8[fmt]).float().numpy()
    return np.unique(v[np.isfinite(v)])


# ---------------------------------------------------------------------------
# fp8_grid_round
# ---------------------------------------------------------------------------

def _grid_round_cases(fmt) -> np.ndarray:
    g = _grid(fmt)
    unit = g[np.abs(g) <= 1.0]
    mids = ((g[:-1].astype(np.float64) + g[1:]) / 2).astype(np.float32)
    exact = np.concatenate([unit, g, mids]).astype(np.float32)
    up = np.nextafter(exact, np.float32(np.inf))
    down = np.nextafter(exact, np.float32(-np.inf))
    fmax = Q.FP8_MAX[fmt]
    beyond = np.array([fmax * 1.01, -fmax * 1.5, 1e30, -1e30, 0.0, -0.0], np.float32)
    return np.concatenate([exact, up, down, beyond])


@pytest.mark.parametrize("fmt", FMTS)
def test_grid_round_matches_jax_on_the_grid_and_its_ties(fmt):
    x = _grid_round_cases(fmt)
    want = np.asarray(JQ.fp8_grid_round(jnp.asarray(x), fmt))
    got = Q.fp8_grid_round(torch.from_numpy(x), fmt).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # every result lies on the grid: the cast to the fp8 dtype is exact
    assert np.isin(np.abs(got), _grid(fmt)).all()
    np.testing.assert_array_equal(
        torch.from_numpy(got).to(TORCH_FP8[fmt]).float().numpy().view(np.uint32),
        got.view(np.uint32))
    # and a midpoint rounds to the neighbour with the even mantissa
    g = _grid(fmt)
    pos = g[(g >= 0) & (g < Q.FP8_MAX[fmt])]
    mids = ((pos[:-1].astype(np.float64) + pos[1:]) / 2).astype(np.float32)
    r = Q.fp8_grid_round(torch.from_numpy(mids), fmt).to(TORCH_FP8[fmt])
    assert (r.view(torch.uint8).numpy() % 2 == 0).all()


@pytest.mark.parametrize("fmt", FMTS)
def test_grid_round_matches_jax_on_a_million_random_values(fmt):
    rng = np.random.default_rng(11 if fmt == "e4m3" else 12)
    mant = rng.uniform(-2.0, 2.0, 10 ** 6)
    x = np.ldexp(mant, rng.integers(-30, 20, 10 ** 6)).astype(np.float32)
    want = np.asarray(JQ.fp8_grid_round(jnp.asarray(x), fmt))
    got = Q.fp8_grid_round(torch.from_numpy(x), fmt).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("fmt", FMTS)
def test_fp8_quantizers_of_core_match_jax(fmt):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((40, 33)) * 5).astype(np.float32)
    x[3] = 0.0
    for name in ("quantize_tensorwise_fp8", "quantize_rowwise_fp8"):
        jq, js = getattr(JQ, name)(jnp.asarray(x), fmt)
        tq, ts = getattr(Q, name)(torch.from_numpy(x), fmt)
        _same(tq, jq, name)
        _same(ts, js, name)
        assert tq.dtype == torch.float32 and tuple(ts.shape) == np.shape(js)


# ---------------------------------------------------------------------------
# the three quantizers
# ---------------------------------------------------------------------------

def _activations(rng, R, C, tile=(128, 128)):
    """Values over several binades, an all-zero row and an all-zero tile
    (the second tile row's first tile when the array has one)."""
    x = (rng.standard_normal((R, C)) * np.exp(rng.uniform(-6, 6, (R, 1)))).astype(np.float32)
    x[min(2, R - 1)] = 0.0
    if R > tile[0]:
        x[tile[0]:2 * tile[0], :tile[1]] = 0.0
    return x


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("R,C", [(1, 1), (7, 3), (130, 129), (300, 270)])
def test_quantizers_match_jax(R, C, fmt, dt):
    rng = np.random.default_rng(R * 7 + C)
    jdt, tdt = DTYPES[dt]
    x = _activations(rng, R, C)
    tx = torch.from_numpy(x).to(tdt)
    jx = jnp.asarray(x).astype(jdt)
    for name, kw in (("row_quantize", {}), ("tensor_quantize", {}),
                     ("block_quantize", dict(block_rows=128, block_cols=128)),
                     ("block_quantize", dict(block_rows=64, block_cols=32))):
        jq, js = getattr(JF8, name)(jx, fmt=fmt, backend="pallas_interpret", **kw)
        tq, ts = getattr(F8, name)(tx, fmt, **kw)
        assert tq.dtype == TORCH_FP8[fmt] and ts.dtype == torch.float32
        _same(tq, jq, f"{name} {kw} q")
        _same(ts, js, f"{name} {kw} state")


def test_block_quantize_edge_tiles_take_their_real_elements():
    """4,128 rows in tiles of 128 make 33 row tiles (the last holds 32 real
    rows), as the JAX package's zero-padded grid; an edge tile's scale is
    the absmax of its real elements."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4128, 200)).astype(np.float32)
    q, s = F8.block_quantize(torch.from_numpy(x), "e4m3")
    assert tuple(s.shape) == (33, 2)
    assert float(s[32, 1]) == float(np.abs(x[4096:, 128:]).max())


# ---------------------------------------------------------------------------
# fallback_mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state", [
    [[1.0, 2.0], [3.0, 40.0]],                       # even: median 2.5 (torch: 2)
    [[1.0, 2.0, 3.0, 4.0, 50.0, 0.5]],               # even, unsorted
    [[1.0, 2.0, 3.0], [4.0, 5.0, 41.0], [7.0, 8.0, 9.0]],  # odd
    [[1e-12, 1e-12], [1e-12, 1e-12]],                # all floors (γ = 0 at step 0)
])
def test_fallback_mask_matches_jax(state):
    s = np.asarray(state, np.float32)
    for ratio in (8.0, 2.0, 1.5):
        want = np.asarray(JF8.fallback_mask(jnp.asarray(s), ratio))
        got = F8.fallback_mask(torch.from_numpy(s), ratio)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_fallback_mask_takes_the_mean_of_the_middle_pair_and_is_strict():
    s = torch.tensor([[1.0, 2.0], [3.0, 20.0]])
    # median 2.5: 20 = 8 * 2.5 exactly is not above it; torch.median's 2.0
    # would have made it a fallback tile
    assert F8.fallback_mask(s, 8.0).sum() == 0
    assert float(torch.median(s)) == 2.0 and 20.0 > 8.0 * 2.0
    assert np.asarray(JF8.fallback_mask(jnp.asarray(s.numpy()), 8.0)).sum() == 0
    s[1, 1] = float(np.nextafter(np.float32(20.0), np.float32(np.inf)))
    assert F8.fallback_mask(s, 8.0).tolist() == [[0.0, 0.0], [0.0, 1.0]]


# ---------------------------------------------------------------------------
# fp8_matmul_dequant
# ---------------------------------------------------------------------------

def test_choose_blocks_is_the_jax_packages():
    for shape in [(4128, 1280, 1280), (4128, 1280, 5120), (4128, 5120, 1280), (8192, 588, 1280),
                  (2464, 1024, 4096), (2464, 4096, 1024), (8, 960, 320), (37, 130, 70)]:
        assert F8REF.choose_blocks(*shape) == jax_choose_blocks(*shape)
    assert [F8REF.block_k(4128, K, 1280) for K in (1280, 1024, 5120, 4096, 588)] == \
        [1024, 1024, 4096, 4096, 512]


def _exact_blocked(xq, wq, rs, bk, out_dtype, transpose_w):
    """numpy: each k-block's sum in exact integer units, rounded once to
    f32, added in k order in f32; then times the row scale."""
    x = xq.float().numpy().astype(np.float64)
    w = wq.float().numpy().astype(np.float64)
    w = w.T if transpose_w else w
    ux, uw = 2.0 ** 16, 2.0 ** 9          # E5M2 / E4M3 grid units in [-1, 1]
    xi, wi = np.rint(x * ux).astype(np.int64), np.rint(w * uw).astype(np.int64)
    assert np.array_equal(xi / ux, x) and np.array_equal(wi / uw, w)
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, x.shape[1], bk):
        s = xi[:, k0:k0 + bk] @ wi[k0:k0 + bk]           # exact in int64
        acc = acc + (s / (ux * uw)).astype(np.float32)
    return torch.from_numpy(acc * rs.numpy()).to(out_dtype)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("transpose_w", [False, True], ids=["fwd", "dgrad_t"])
@pytest.mark.parametrize("B,K,M", [(5, 40, 7), (37, 600, 70), (300, 1100, 96)])
def test_fp8_matmul_dequant_matches_jax(B, K, M, transpose_w, dt):
    rng = np.random.default_rng(B + K + M)
    jdt, tdt = DTYPES[dt]
    xfmt = "e5m2" if transpose_w else "e4m3"
    x = _activations(rng, B, K)
    w = (rng.standard_normal((M, K) if transpose_w else (K, M)) / np.sqrt(K)).astype(np.float32)
    jxq, jsx = JF8.row_quantize(jnp.asarray(x), fmt=xfmt, backend="pallas_interpret")
    jwq, jsw = JF8.tensor_quantize(jnp.asarray(w), fmt="e4m3", backend="pallas_interpret")
    rs = jsx * jsw
    jy = JF8.fp8_matmul_dequant(jxq, jwq, rs, transpose_w=transpose_w, out_dtype=jdt,
                                backend="pallas_interpret")
    txq, twq = _fp8_bits(jxq, xfmt), _fp8_bits(jwq, "e4m3")
    trs = torch.from_numpy(np.array(rs))
    fn = F8.fp8_matmul_dequant_t if transpose_w else F8.fp8_matmul_dequant
    y = fn(txq, twq, trs, out_dtype=tdt)
    assert y.dtype == tdt and tuple(y.shape) == (B, M)
    bk = F8REF.block_k(B, K, M)
    _same(y, _exact_blocked(txq, twq, trs, bk, tdt, transpose_w), "exact per k-block")
    assert _rel(y, jy) <= MATMUL_TOL[dt], _rel(y, jy)


# ---------------------------------------------------------------------------
# fp8_mixed_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("transpose_w", [False, True], ids=["fwd", "dgrad_t"])
@pytest.mark.parametrize("B,K,M,br,bc", [(300, 384, 96, 128, 128), (70, 100, 40, 16, 32),
                                         (33, 64, 20, 16, 16)])
def test_fp8_mixed_matmul_matches_jax(B, K, M, br, bc, transpose_w, dt):
    rng = np.random.default_rng(B * 3 + K + M)
    jdt, tdt = DTYPES[dt]
    fmt = "e5m2" if transpose_w else "e4m3"
    x = rng.standard_normal((B, K)).astype(np.float32)
    x[min(br, B) - 1, min(bc, K) - 1] = 400.0           # an outlier tile
    x[B - 1, K - 1] = -300.0                            # and one at the ragged corner
    w = (rng.standard_normal((M, K) if transpose_w else (K, M)) / np.sqrt(K)).astype(np.float32)
    jwq, jsw = JF8.tensor_quantize(jnp.asarray(w), fmt="e4m3", backend="pallas_interpret")
    twq, tsw = _fp8_bits(jwq, "e4m3"), torch.from_numpy(np.array(jsw))
    _, s_blk = F8.block_quantize(torch.from_numpy(x), fmt, br, bc)
    fb = F8.fallback_mask(s_blk, 8.0)
    assert 0 < int(fb.sum()) < fb.numel()               # both branches run
    for ratio in (8.0, 1e-30, 1e30):                    # mixed, all bf16, all fp8
        jy = JF8.fp8_mixed_matmul(jnp.asarray(x).astype(jdt), jwq, jsw, fmt=fmt,
                                  block_rows=br, block_cols=bc, fallback_ratio=ratio,
                                  transpose_w=transpose_w, out_dtype=jdt,
                                  backend="pallas_interpret")
        y = F8.mixed(torch.from_numpy(x).to(tdt), twq, tsw, fmt=fmt, block_rows=br,
                     block_cols=bc, fallback_ratio=ratio, transpose_w=transpose_w,
                     out_dtype=tdt)
        assert y.dtype == tdt and tuple(y.shape) == (B, M)
        assert _rel(y, jy) <= MATMUL_TOL[dt], (ratio, _rel(y, jy))


def test_fp8_mixed_fallback_changes_the_outlier_tiles_only():
    """With its outlier tile in bf16 the product of the outlier's rows is
    closer to the exact product than with every tile in fp8, and rows of
    clean tiles do not change."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((256, 256)).astype(np.float32)
    x[5, 7] = 1000.0
    w = (rng.standard_normal((256, 64)) / 16).astype(np.float32)
    wq, sw = F8.tensor_quantize(torch.from_numpy(w), "e4m3")
    tx = torch.from_numpy(x)
    mixed = F8.mixed(tx, wq, sw, fallback_ratio=8.0, out_dtype=torch.float32)
    all8 = F8.mixed(tx, wq, sw, fallback_ratio=1e30, out_dtype=torch.float32)
    exact = tx.double() @ (wq.double() * sw.double())
    assert torch.equal(mixed[128:], all8[128:])
    err = lambda y: float((y[:128].double() - exact[:128]).abs().max())
    assert err(mixed) < err(all8)


def test_fp8_wrappers_check_and_count_no_cpu_launch():
    F8.reset_launch_counts()
    x = torch.randn(8, 16)
    q, s = F8.row_quantize(x, "e4m3")
    wq, sw = F8.tensor_quantize(torch.randn(16, 4), "e4m3")
    F8.fp8_matmul_dequant(q, wq, s * sw)
    F8.mixed(x, wq, sw)
    assert all(v == 0 for v in F8.launch_counts().values())
    assert set(F8.launch_counts()) == {
        "fp8_row_quantize", "fp8_tensor_quantize", "fp8_block_quantize", "fp8_matmul_dequant",
        "fp8_matmul_dequant_t", "fp8_mixed_matmul", "fp8_mixed_matmul_t",
        "fp8_transpose_bytes"}
    with pytest.raises(ValueError, match="unknown fp8 format"):
        F8.row_quantize(x, "e3m4")
    with pytest.raises(ValueError, match="does not contract"):
        F8.fp8_matmul_dequant(q, wq.t().contiguous(), s * sw)
    with pytest.raises(TypeError):
        F8.fp8_matmul_dequant(q.float(), wq, s * sw)
    with pytest.raises(ValueError, match="tile grid"):
        F8.fp8_mixed_matmul(x, q, s, s, wq, sw)
