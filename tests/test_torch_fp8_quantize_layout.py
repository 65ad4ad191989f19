"""The fp8 row and tile quantizers' work split and per-value arithmetic,
modelled in numpy (no card, no JAX; a few seconds).

``kernels/fp8_matmul/csrc/fp8_matmul.cu`` runs ``row_quantize`` and
``block_quantize`` as one tile kernel (a row is a 1 x K tile): a group of
2^gshift threads owns a tile and holds it in registers as chunks of
``kChunk`` values, thread t taking chunks t, t + group, ... (at most
``kMaxChunks``), each chunk's (row, column chunk) stepped from the last by
``divmod(group, cpr)``; tiles too large for that (``kWide``) take a block
and two passes. The model repeats the launcher's choice (group, path,
grid) and every thread's index arithmetic, and checks that each element of
x is read by exactly one thread and its byte written once, by a thread of
the group that owns its row or tile (so each absmax covers exactly its
tile), that one thread writes each tile's state, and that the 16-byte
loads and 8-byte stores of the aligned path are aligned.

The kernels take each byte from the card's conversion (``cvt.rn.satfinite``:
round to nearest even onto the fp8 grid, saturating at the format's max)
after ``fmaxf(x / absmax, -max)``, where the plain versions round with
``fp8_grid_round`` and cast. The model of that arithmetic (IEEE f32
division, NaN to -max, the nearest fp8 value with ties to the even code,
saturated) is held bitwise against ``ref.cast`` over every bf16 bit pattern
at a spread of absmax values and against the kernels' former arithmetic
(``grid_round`` behind IEEE ``fminf``/``fmaxf`` clips, which map NaN to
-max) on non-finite inputs and on f32 values at and beside every rounding
boundary. On the card ``encode_check`` holds the conversion instruction
itself against ``grid_round`` + ``encode`` over every f32 bit pattern.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.quantization import FP8_DTYPES, FP8_MAX, fp8_grid_round
from repro_torch.kernels.fp8_matmul import ref as F8REF

torch.set_num_threads(1)

SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "fp8_matmul"
       / "csrc" / "fp8_matmul.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+)", SRC).group(1))


CHUNK, MAX_CHUNKS, THREADS = _const("kChunk"), _const("kMaxChunks"), _const("kThreads")
FMTS = ("e4m3", "e5m2")


# ---------------------------------------------------------------------------
# the work split
# ---------------------------------------------------------------------------

def plan(R, C, br, bc, aligned=True):
    """``quantize_tiles_launch``: the tile grid, the group, the path and the
    grid of blocks."""
    nbc = -(-C // bc)
    ntiles = -(-R // br) * nbc
    cpr = -(-bc // CHUNK)
    chunks = br * cpr
    gshift = 5
    while gshift < 8 and chunks > MAX_CHUNKS << gshift:
        gshift += 1
    n_per = -(-chunks // (1 << gshift))
    dr, dc = divmod(1 << gshift, cpr)
    fits = n_per <= MAX_CHUNKS and br * C <= 2 ** 32 - 1     # offsets from a tile's start in 32 bits
    path = ("wide" if not fits else
            "vec" if aligned and C % CHUNK == 0 and bc % CHUNK == 0 else "masked")
    blocks = ntiles if path == "wide" else (ntiles + (THREADS >> gshift) - 1) >> (8 - gshift)
    return dict(R=R, C=C, br=br, bc=bc, nbc=nbc, ntiles=ntiles, cpr=cpr, gshift=gshift,
                np=n_per, dr=dr, dc=dc, path=path, blocks=blocks)


def tile_of(p, tile):
    """(r0, c0, rows, cols) of each tile index."""
    tr, tc = tile // p["nbc"], tile % p["nbc"]
    r0, c0 = tr * p["br"], tc * p["bc"]
    return r0, c0, np.minimum(p["br"], p["R"] - r0), np.minimum(p["bc"], p["C"] - c0)


def register_accesses(p):
    """``quantize_tiles``: per (thread, chunk j) the offset and count of the
    values it reads and writes, its tile and whether it writes the state;
    also each thread's group (the warps whose maxima it reads)."""
    tid = np.arange(p["blocks"] * THREADS)
    blk, thr = tid // THREADS, tid % THREADS
    g, t = thr >> p["gshift"], thr & ((1 << p["gshift"]) - 1)
    tile = (blk << (8 - p["gshift"])) + g
    live = tile < p["ntiles"]
    r0, c0, rows, cols = tile_of(p, tile)
    r, cc = t // p["cpr"], t % p["cpr"]                     # once a thread
    offs, counts = [], []
    for j in range(MAX_CHUNKS):
        # the stepped place is the plain divmod of chunk t + group j
        np.testing.assert_array_equal((r, cc), divmod(t + (j << p["gshift"]), p["cpr"]))
        col = CHUNK * cc
        ok = live & (j < p["np"]) & (r < rows) & (col < cols)
        counts.append(np.where(ok, np.minimum(CHUNK, cols - col), 0))
        off = r * p["C"] + col                              # from the tile's first value
        assert (off[ok] < 2 ** 32).all()
        offs.append(r0 * p["C"] + c0 + off)
        r, cc = r + p["dr"], cc + p["dc"]
        wrap = cc >= p["cpr"]
        cc, r = np.where(wrap, cc - p["cpr"], cc), np.where(wrap, r + 1, r)
    # the warps a thread reads the maxima of (one exchange above a warp)
    w0 = (g << p["gshift"]) >> 5
    nw = 1 << max(p["gshift"] - 5, 0)
    warps = blk[:, None] * (THREADS // 32) + w0[:, None] + np.arange(nw)[None, :]
    return dict(off=np.stack(offs, 1), n=np.stack(counts, 1), tile=tile, live=live,
                writes_state=live & (t == 0), warps=warps)


def wide_accesses(p):
    """``quantize_wide``: a block a tile, element i at (i / cols, i % cols)
    stepped by divmod(kThreads, cols); both passes visit the same
    elements."""
    offs, tiles = [], []
    for tile in range(p["ntiles"]):
        r0, c0, rows, cols = (int(v) for v in tile_of(p, np.int64(tile)))
        dr, dc = divmod(THREADS, cols)
        for t in range(THREADS):
            r, c = divmod(t, cols)
            while r < rows:
                offs.append((r0 + r) * p["C"] + c0 + c)
                tiles.append(tile)
                r, c = r + dr, c + dc
                if c >= cols:
                    c, r = c - cols, r + 1
    return np.array(offs, dtype=np.int64), np.array(tiles, dtype=np.int64)


def true_tile(p, off):
    row, col = off // p["C"], off % p["C"]
    return row // p["br"] * p["nbc"] + col // p["bc"]


def check_split(R, C, br, bc, aligned=True):
    p = plan(R, C, br, bc, aligned)
    if p["path"] == "wide":
        off, tile = wide_accesses(p)
        assert np.array_equal(tile, true_tile(p, off))
        counts = np.bincount(off, minlength=R * C)
        assert counts.shape == (R * C,) and (counts == 1).all()
        return p
    a = register_accesses(p)
    n, off = a["n"], a["off"]
    e = np.arange(CHUNK)
    used = e[None, None, :] < n[:, :, None]
    flat = (off[:, :, None] + e[None, None, :])[used]
    # every element read (and, from the same registers, written) once
    counts = np.bincount(flat, minlength=R * C)
    assert counts.shape == (R * C,) and (counts == 1).all(), (R, C, br, bc)
    # by a thread of the group that owns its tile
    owner = np.broadcast_to(a["tile"][:, None, None], used.shape)[used]
    assert np.array_equal(owner, true_tile(p, flat))
    # a group's warps hold its threads only: warp w's threads are one tile's
    warp_tile = a["tile"].reshape(-1, 32)
    assert (warp_tile == warp_tile[:, :1]).all()
    assert (warp_tile[a["warps"], 0] == a["tile"][:, None]).all()
    # one writer of each tile's state
    assert np.array_equal(np.bincount(a["tile"][a["writes_state"]], minlength=p["ntiles"]),
                          np.ones(p["ntiles"], dtype=np.int64))
    # at most kMaxChunks chunks a thread
    assert (np.count_nonzero(n, axis=1) <= MAX_CHUNKS).all() and p["np"] <= MAX_CHUNKS
    if p["path"] == "vec":
        live = n > 0
        assert set(np.unique(n[live])) <= {CHUNK}
        assert (off[live] % CHUNK == 0).all()                  # 16-byte loads, 8-byte stores
    return p


PATH_SHAPES = [(4128, 1280), (4128, 5120), (2464, 1024), (2464, 4096), (8192, 588), (37, 130),
               (37, 2048), (37, 2049)]


@pytest.mark.parametrize("R,C", PATH_SHAPES)
def test_row_quantize_reads_each_value_once_in_its_rows_group(R, C):
    p = check_split(R, C, 1, C)
    assert p["path"] == ("vec" if C % 8 == 0 else "masked")
    # a warp a row up to 2,048 values; a small block per row above
    assert (p["gshift"] == 5) == (C <= 2048)
    assert p["np"] == -(-C // (8 << p["gshift"]))


@pytest.mark.parametrize("br,bc", [(128, 128), (64, 32), (64, 64)])
@pytest.mark.parametrize("R,C", PATH_SHAPES)
def test_block_quantize_reads_each_value_once_in_its_tiles_group(R, C, br, bc):
    br, bc, _, _ = F8REF.tile_grid(R, C, br, bc)
    p = check_split(R, C, br, bc)
    assert p["path"] in ("vec", "masked")


def test_the_edges_and_paths():
    """Ragged edge tiles (4,128 = 32 x 128 + 32 rows, 588 = 4 x 128 + 76
    columns), an odd offset (not 16-byte aligned: the masked path), tile
    shapes off the chunk, and tiles too large for registers (the wide path)."""
    assert plan(4128, 1280, 128, 128)["ntiles"] == 33 * 10
    assert plan(8192, 588, 128, 128)["path"] == "masked"
    assert check_split(300, 1280, 128, 128, aligned=False)["path"] == "masked"
    assert check_split(300, 1280, 1, 1280, aligned=False)["path"] == "masked"
    for br, bc in ((3, 5), (7, 100), (1, 1), (130, 12)):
        check_split(37, 130, br, bc)
    assert check_split(5, 16385, 1, 16385)["path"] == "wide"
    assert check_split(300, 130, 256, 130)["path"] == "wide"
    assert check_split(2, 16384, 1, 16384)["path"] == "vec"


# ---------------------------------------------------------------------------
# the per-value arithmetic
# ---------------------------------------------------------------------------

def fp8_values(fmt):
    """The finite non-negative values of the format in code order (0, 1, ...)."""
    codes = torch.arange(128, dtype=torch.int32).to(torch.uint8)
    v = codes.view(FP8_DTYPES[fmt]).float().numpy().astype(np.float64)
    return v[np.isfinite(v)]


def model_bytes(y, fmt):
    """The kernels' conversion: NaN to -max (fmaxf), then the nearest fp8
    value, ties to the even code, saturated at max; the sign kept (-0 too)."""
    y = np.fmax(np.asarray(y, dtype=np.float32), np.float32(-FP8_MAX[fmt]))
    vals = fp8_values(fmt)
    a = np.abs(y).astype(np.float64)
    hi = np.clip(np.searchsorted(vals, a, side="left"), 1, len(vals) - 1)
    lo = hi - 1
    mid = (vals[lo] + vals[hi]) / 2                 # exact: a few significant bits
    code = np.where(a < mid, lo, np.where(a > mid, hi, np.where(lo % 2 == 0, lo, hi)))
    code = np.where(a <= vals[0], 0, np.where(a >= vals[-1], len(vals) - 1, code))
    return (code | np.where(np.signbit(y), 0x80, 0)).astype(np.uint8)


def former_bytes(y, fmt):
    """The kernels' former arithmetic on y: grid_round's clip as fmaxf then
    fminf (NaN to -max), the rounding, the exact encoding."""
    m = np.float32(FP8_MAX[fmt])
    yc = np.fmin(np.fmax(np.asarray(y, dtype=np.float32), -m), m)
    q = fp8_grid_round(torch.from_numpy(yc), fmt).to(FP8_DTYPES[fmt])
    return q.view(torch.uint8).numpy()


def all_bf16():
    return torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)


FAST_MAX = 2.0 ** 126          # the kernels' kFastMax


def fma32(a, b, c):
    """RN32(a b + c) elementwise for f32 arrays, exactly: the product in
    float64 (exact, 48 bits), the sum by TwoSum (s + err is the exact sum),
    then one rounding to f32, a float64 sum that lands on an f32 midpoint
    broken toward err."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        s = p + c64
        bb = s - p
        err = (p - (s - bb)) + (c64 - bb)
        out = s.astype(np.float32)
        back = out.astype(np.float64)
        other = np.nextafter(out, np.where(back < s, np.float32(np.inf), np.float32(-np.inf)))
        mid = (back + other.astype(np.float64)) / 2
        tie = (back != s) & (s == mid) & (err != 0)
        toward = np.where(err > 0, np.maximum(out, other), np.minimum(out, other))
    return np.where(tie, toward, out)


def kernel_divide(x, a):
    """The bf16 quantizers' x / a: r = RN(1 / a), q = RN(x r), RN(q + RN(x -
    a q) r), x's sign put back; the IEEE division from a = 2^126 on."""
    x, a = np.asarray(x, dtype=np.float32), np.float32(a)
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        if not a < FAST_MAX:
            return x / a
        r = np.float32(1) / a
        q = x * r
        e = fma32(np.full_like(x, -a), q, x)
        y = fma32(e, np.full_like(x, r), q)
    return (y.view(np.uint32) | (x.view(np.uint32) & np.uint32(0x80000000))).view(np.float32)


def bf16_absmax_spread(n=48, seed=3):
    """Every absmax a bf16 row or tile can have is a bf16 value >= 1e-12 or
    the floor 1e-12 itself: the floor, powers of two, the largest below
    2^126 and past it, and ``n`` drawn at random."""
    rng = np.random.default_rng(seed)
    lo = int(np.float32(F8REF.EPS).view(np.uint32) >> 16) + 1
    bits = np.concatenate([rng.integers(lo, 0x7F80, n), [0x3F80, 0x3F81, 0x3FFF, 0x2B8C,
                                                         0x7E7F, 0x7E80, 0x7F7F]])
    return [np.float32(F8REF.EPS)] + list((bits.astype(np.uint32) << 16).view(np.float32))


def test_the_bf16_division_gives_the_ieee_bytes_for_every_bf16_value():
    """The kernels' division for bf16 inputs, on every bf16 x with |x| <= a
    (or NaN: a tile's absmax is at least each |x|) at a spread of the absmax
    values a bf16 tile can have: the IEEE quotient's bits where |x| >=
    2^-100 and the quotient is normal, and the same fp8 bytes in both
    formats everywhere (below that the residual x - a q underflows, but both
    quotients lie far under half the least fp8 step). The card's ``divide_check`` covers every such
    absmax."""
    x = all_bf16().float().numpy()
    tiny = np.float32(2.0 ** -126)
    for a in bf16_absmax_spread():
        keep = (np.abs(x) <= a) | np.isnan(x)
        xs = x[keep]
        got = kernel_divide(xs, a)
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            want = xs / a
        normal = (np.abs(xs) >= 2.0 ** -100) & (np.abs(want) >= tiny)
        same = got.view(np.uint32) == want.view(np.uint32)
        assert same[normal].all(), (a, xs[normal & ~same][:4])
        rest = got[~normal & ~np.isnan(got)]
        assert (np.abs(rest) < 2.0 ** -60).all()              # far under any fp8 step
        for fmt in FMTS:
            np.testing.assert_array_equal(model_bytes(got, fmt), model_bytes(want, fmt))


def ieee_divide(x, a):
    """The f32 quantizers' x / a: __fdiv_rn, IEEE."""
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        return np.asarray(x, dtype=np.float32) / np.float32(a)


def absmax_spread():
    """f32 absmax values: powers of two, just above a row's largest |x|, a
    value of many significant bits, bf16 subnormals' scale, the 1e-12
    floor, the largest."""
    f32 = np.float32
    return [f32(1.0), f32(2.0 ** -20), f32(2.0 ** 40), f32(F8REF.EPS),
            np.nextafter(f32(1.0), f32(2.0)), np.nextafter(f32(3.0), f32(4.0)),
            f32(448.0) * np.nextafter(f32(1.0), f32(2.0)), f32(0.7853981633974483),
            f32(3.1e-38), f32(1.7e38), f32(np.inf)]


@pytest.mark.parametrize("route", ["bf16", "f32"])
@pytest.mark.parametrize("fmt", FMTS)
def test_the_conversion_gives_ref_cast_bytes_for_every_bf16_value(fmt, route):
    """Every bf16 bit pattern x (±0, subnormals, exact fp8 ties at
    power-of-two absmax, ±inf, NaN) with |x| <= a (or NaN) divided by each
    absmax a as the kernels divide it (bf16: ``kernel_divide`` at the absmax
    values a bf16 tile can have; f32: IEEE at f32 ones): the model's bytes
    equal ``ref.cast``'s wherever x is not NaN, and the kernels' former
    bytes (grid_round of the IEEE quotient) everywhere, NaN included (x NaN,
    or inf / inf): -max, as grid_round's clip maps it."""
    x = all_bf16()
    xs = x.float().numpy()
    spread, divide = ((bf16_absmax_spread(), kernel_divide) if route == "bf16" else
                      (absmax_spread(), ieee_divide))
    for a in spread:
        keep = (np.abs(xs) <= a) | np.isnan(xs)
        got = model_bytes(divide(xs[keep], a), fmt)
        want = F8REF.cast(x[torch.from_numpy(keep)], torch.tensor(a), fmt).view(torch.uint8)
        finite = ~np.isnan(ieee_divide(xs[keep], a))          # ref.cast keeps a NaN
        np.testing.assert_array_equal(got[finite], want.numpy()[finite], err_msg=f"{a!r}")
        np.testing.assert_array_equal(got, former_bytes(ieee_divide(xs[keep], a), fmt),
                                      err_msg=f"absmax {a!r}")
    # the cases named: ±0 keep their sign, NaN and ±inf as before
    z = model_bytes(np.array([0.0, -0.0, np.nan, np.inf, -np.inf], np.float32), fmt)
    top = 0x7E if fmt == "e4m3" else 0x7B
    assert list(z) == [0x00, 0x80, 0x80 | top, top, 0x80 | top]


def boundary_f32(fmt):
    """f32 values at, just below and just above every rounding boundary of
    the format (the midpoints between neighbouring fp8 values, both signs),
    at every fp8 value, and f32 subnormals and out-of-range magnitudes."""
    vals = fp8_values(fmt).astype(np.float32)
    mids = ((vals[:-1].astype(np.float64) + vals[1:]) / 2).astype(np.float32)
    base = np.concatenate([vals, mids, np.float32([1e-45, 1e-40, 1.2e-38, 1e30, 3e38])])
    near, up, down = [base], base, base
    for _ in range(3):
        up, down = np.nextafter(up, np.float32(np.inf)), np.nextafter(down, np.float32(0))
        near += [up, down]
    v = np.concatenate(near)
    return np.concatenate([v, -v, v / np.float32(2.0 ** 10), v * np.float32(2.0 ** -3)])


@pytest.mark.parametrize("fmt", FMTS)
def test_the_conversion_matches_grid_round_at_every_rounding_boundary(fmt):
    y = boundary_f32(fmt)
    np.testing.assert_array_equal(model_bytes(y, fmt), former_bytes(y, fmt))
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 1 << 32, size=1 << 20, dtype=np.uint64).astype(np.uint32)
    y = bits.view(np.float32)
    np.testing.assert_array_equal(model_bytes(y, fmt), former_bytes(y, fmt))


@pytest.mark.parametrize("fmt", FMTS)
def test_row_and_tile_quantize_of_the_model_equal_ref(fmt):
    """The model with the kernels' own absmax (a row's or a tile's, floored)
    gives the plain versions' q on f32 inputs of many scales, with an
    all-zero row and tile, ±0 and subnormals."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((70, 130)) * np.exp(rng.uniform(-30, 30, (70, 1)))).astype(np.float32)
    x[3] = 0.0
    x[5, :7] = [0.0, -0.0, 1e-40, -1e-42, 2.0 ** -130, 3.0, -3.0]
    x[64:, :64] = 0.0
    q, s = F8REF.row_quantize(torch.from_numpy(x), fmt)
    np.testing.assert_array_equal(model_bytes(x / s.numpy(), fmt), q.view(torch.uint8).numpy())
    for br, bc in ((64, 32), (64, 64), (128, 128)):
        q, s = F8REF.block_quantize(torch.from_numpy(x), fmt, br, bc)
        b, c, _, _ = F8REF.tile_grid(70, 130, br, bc)
        am = F8REF.expand_tiles(s, 70, 130, b, c).numpy()
        np.testing.assert_array_equal(model_bytes(x / am, fmt), q.view(torch.uint8).numpy())
