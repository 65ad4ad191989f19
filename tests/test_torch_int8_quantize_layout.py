"""The int8 row and column quantizers' work split, modelled in numpy (no
card, no JAX; a few seconds).

``kernels/switchback/csrc/switchback.cu`` runs ``row_quantize`` (and the
fused pair's first pass) as one row body, ``quantize_rows``: a group of
2^gshift threads owns a row and holds it in registers as chunks of
``kChunk`` values, thread t taking chunks t, t + group, ... (at most
``kMaxChunks``); rows too long for that take the wide path (a block a row,
two passes). ``col_quantize`` gives a block a band of ``kBand`` columns over
a slab of rows, thread t taking chunk column t % 4 and rows t / 4 + 64 j,
and makes a band's slabs one thread block cluster; past ``kMaxCluster``
slabs it takes the wide path (a block owns 32 columns over every row).

The model repeats both launchers' choices (group, granule, grid, slabs and
cluster) and every thread's index arithmetic, and checks at every edge
shape of ``chip_smoke.py``'s phase 13 and every CLIP and smollm path shape:
each element of x is read by exactly one thread, of the group (row) or
cluster (band) that owns it, and its byte written once from the same
registers; each state is written once, by one thread; the loads and stores
of the 8- and 4-value granules are aligned. It also runs the kernels'
reductions (the warp shuffles, the warps' maxima in shared memory, the
cluster's slabs) on random values and holds the absmax they give, and the
codes from it, to the plain versions in ``ref.py``.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.switchback import ref as REF

torch.set_num_threads(1)

SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "switchback"
       / "csrc" / "switchback.cu").read_text()


def _const(name: str) -> int:
    expr = re.search(rf"constexpr int {name} = ([^;]+);", SRC).group(1)
    return int(eval(re.sub(r"\bk\w+", lambda m: str(_const(m.group(0))), expr)))


THREADS, CHUNK, MAX_CHUNKS = _const("kThreads"), _const("kChunk"), _const("kMaxChunks")
BAND, BAND_CHUNKS, STEP = _const("kBand"), _const("kBandChunks"), _const("kSlabStep")
MAX_CLUSTER, COL_CHUNKS, SPLIT = _const("kMaxCluster"), _const("kColChunks"), _const("kColRowSplit")
BYTES = {"bf16": 2, "f32": 4}


def granule(W, x_addr, dt, q_addr=0):
    """``granule``: 8, 4 or 1 values a load, by x's (and q's) alignment and
    the width W."""
    if W % 8 == 0 and x_addr % 16 == 0 and q_addr % 8 == 0:
        return 8
    if W % 4 == 0 and x_addr % (4 * BYTES[dt]) == 0 and q_addr % 4 == 0:
        return 4
    return 1


# ---------------------------------------------------------------------------
# row_quantize
# ---------------------------------------------------------------------------

def row_plan(B, K, x_addr=0, dt="bf16"):
    """``launch_rows``: the group, the chunks a thread, the path and the grid."""
    chunks = -(-K // CHUNK)
    gshift = 5
    while gshift < 8 and chunks > MAX_CHUNKS << gshift:
        gshift += 1
    n_per = -(-chunks // (1 << gshift))
    G = 0 if n_per > MAX_CHUNKS else granule(K, x_addr, dt)
    blocks = B if G == 0 else (B + (THREADS >> gshift) - 1) >> (8 - gshift)
    return dict(B=B, K=K, gshift=gshift, np=n_per, G=G, blocks=blocks)


def row_threads(p):
    """``quantize_rows`` for one block at block index ``blk``: per (thread,
    chunk j) the row, the first column and the count of values."""
    t_all = np.arange(THREADS)
    g, t = t_all >> p["gshift"], t_all & ((1 << p["gshift"]) - 1)

    def at(blk):
        row = (blk << (8 - p["gshift"])) + g
        live = row < p["B"]
        cols, ns = [], []
        for j in range(MAX_CHUNKS):
            c = CHUNK * (t + (j << p["gshift"]))
            ns.append(np.where(live & (j < p["np"]) & (c < p["K"]), np.minimum(CHUNK, p["K"] - c), 0))
            cols.append(c)
        return row, np.stack(cols, 1), np.stack(ns, 1), live & (t == 0)
    return g, t, at


def check_rows(B, K, x_addr=0, dt="bf16"):
    """Every value of x read once by the group of its row (and its byte
    written once from the same registers), each state once, the granules
    aligned; the wide path's two passes visit each value once each."""
    p = row_plan(B, K, x_addr, dt)
    if p["G"] == 0:
        # a block a row: thread i's values i, i + 256, ...; rows by block
        assert p["blocks"] == B and K > MAX_CHUNKS * CHUNK * THREADS
        seen = np.concatenate([np.arange(i, K, THREADS) for i in range(THREADS)])
        assert np.array_equal(np.sort(seen), np.arange(K))
        return p
    g, t, at = row_threads(p)
    # the rows of every block: each row < B owned by exactly one group
    rows = np.concatenate([at(b)[0][t == 0] for b in range(p["blocks"])])
    live_rows = rows[rows < B]
    assert np.array_equal(np.sort(live_rows), np.arange(B))
    # the columns a group reads, the same in every row: model block 0 (and
    # the last, whose groups past B read nothing)
    for blk in {0, p["blocks"] - 1}:
        row, col, n, writes = at(blk)
        for gr in np.unique(g):
            mine = g == gr
            if row[mine][0] >= B:
                assert (n[mine] == 0).all() and not writes[mine].any()
                continue
            e = np.arange(CHUNK)
            used = e[None, None, :] < n[mine][:, :, None]
            flat = (col[mine][:, :, None] + e[None, None, :])[used]
            assert np.array_equal(np.sort(flat), np.arange(K)), (B, K)   # each once
            assert writes[mine].sum() == 1                                # one state
        live = n > 0
        assert (np.count_nonzero(n, axis=1) <= MAX_CHUNKS).all()
        if p["G"] > 1:
            G = p["G"]
            assert (n[live] % G == 0).all()                      # whole granules only
            off = (row[:, None] * K + col)[live]                 # elements from x
            width = min(G * BYTES[dt], 16)                       # bytes a load
            assert ((x_addr + off * BYTES[dt]) % width == 0).all()
            assert (off % G == 0).all()                          # q: G-byte stores
    # a group's warps hold its threads only, and exchange among themselves
    warp_group = g.reshape(-1, 32)
    assert (warp_group == warp_group[:, :1]).all()
    return p


ROW_EDGE_ROWS = (1, 17, 1000, 4128)
ROW_EDGE_K = (1, 7, 588, 960, 1280, 2048, 2049, 4096, 5120, 8192, 16385)
# (rows, K) of row_quantize on the paths: CLIP's X, Ẏ and W of each tower
# (vision 4,128 rows, text 2,464, the patch embedding 8,192 x 588) and
# smollm's (decode 8, prefill 1,024, train 2,048 at K = 960, 2,560 and the
# fused pass's 320)
ROW_PATH = [(4128, 1280), (4128, 5120), (1280, 1280), (1280, 5120), (5120, 1280),
            (2464, 1024), (2464, 4096), (1024, 1024), (1024, 4096), (4096, 1024), (8192, 588),
            (8, 2560), (1024, 2560), (2048, 2560), (2048, 960), (2048, 320)]


@pytest.mark.parametrize("K", ROW_EDGE_K)
@pytest.mark.parametrize("B", ROW_EDGE_ROWS)
def test_row_quantize_reads_each_value_once_at_the_edges(B, K):
    for x_addr, dt in ((0, "bf16"), (2, "bf16"), (8, "bf16"), (0, "f32"), (4, "f32"), (16, "f32")):
        p = check_rows(B, K, x_addr, dt)
    assert (p["G"] == 0) == (K > 16384)


@pytest.mark.parametrize("B,K", ROW_PATH)
def test_row_quantize_reads_each_value_once_on_the_paths(B, K):
    p = check_rows(B, K)
    # a warp a row to 2,048; two warps to 4,096, four to 8,192
    assert (p["gshift"], p["np"]) == {588: (5, 3), 320: (5, 2), 960: (5, 4), 1024: (5, 4),
                                      1280: (5, 5), 2560: (6, 5), 4096: (6, 8),
                                      5120: (7, 5)}[K]
    # 16-byte loads, except the patch embedding's 588: 8-byte loads of bf16
    assert p["G"] == (4 if K == 588 else 8)


# ---------------------------------------------------------------------------
# col_quantize
# ---------------------------------------------------------------------------

def col_plan(R, C, x_addr=0, dt="bf16"):
    """``launch_cols``: bands, slabs (the cluster), chunk steps a slab, the
    granule, or the wide path."""
    bands, steps = -(-C // BAND), -(-R // STEP)
    slabs = -(-steps // COL_CHUNKS)
    if slabs > MAX_CLUSTER or bands > 65535:
        return dict(R=R, C=C, bands=bands, wide=True)
    n_per = -(-steps // slabs)
    return dict(R=R, C=C, bands=bands, slabs=slabs, np=n_per, wide=False,
                G=granule(C, x_addr, dt))


def col_threads(p):
    """``quantize_cols`` over the whole grid (slabs, bands): per (block,
    thread, chunk j) the row, the first column, the count of values; the
    block's slab and band; the state writers."""
    bx, by, t = np.meshgrid(np.arange(p["slabs"]), np.arange(p["bands"]), np.arange(THREADS),
                            indexing="ij")
    bx, by, t = bx.ravel(), by.ravel(), t.ravel()
    c0, cc = by * BAND, t % BAND_CHUNKS
    col = c0 + CHUNK * cc
    cols = np.minimum(CHUNK, p["C"] - col)
    r0 = bx * STEP * p["np"] + t // BAND_CHUNKS
    rows = np.stack([r0 + STEP * j for j in range(COL_CHUNKS)], 1)
    # the first nj chunks lie inside (C's truncating division: the max(0, .)
    # takes the negative quotients)
    nj = np.where(cols > 0, np.maximum(0, np.minimum(p["np"], np.trunc(
        (p["R"] - r0 + STEP - 1) / STEP).astype(np.int64))), 0)
    n = np.where(np.arange(COL_CHUNKS)[None, :] < nj[:, None], cols[:, None], 0)
    assert ((n > 0) == ((np.arange(COL_CHUNKS)[None, :] < p["np"]) & (rows < p["R"])
                        & (cols[:, None] > 0))).all()
    state = (bx == 0) & (t < BAND) & (c0 + t < p["C"])
    return dict(bx=bx, by=by, t=t, col=col, rows=rows, n=n, state_col=(c0 + t)[state])


def check_cols(R, C, x_addr=0, dt="bf16"):
    """Every value read once by a thread of the cluster of its band (in the
    block of its slab), its byte written once from the same registers; each
    column's state once; the granules aligned."""
    p = col_plan(R, C, x_addr, dt)
    if p["wide"]:
        # a block owns 32 columns, one a lane (threads t % 32), and its 8
        # warps split the rows (r = t / 32, + 8, ...): each value once
        lane, split = np.arange(THREADS) % BAND, np.arange(THREADS) // BAND
        col = (np.arange(p["bands"])[:, None] * BAND + lane[None, :]).ravel()
        assert np.array_equal(np.bincount(col[col < C], minlength=C), np.full(C, SPLIT))
        visits = np.bincount(np.concatenate([np.arange(sp, R, SPLIT) for sp in set(split)]),
                             minlength=R)
        assert (visits == 1).all()
        return p
    assert 1 <= p["slabs"] <= MAX_CLUSTER and (p["slabs"] - 1) * STEP * p["np"] < R
    assert p["slabs"] * STEP * p["np"] >= R and p["np"] <= COL_CHUNKS
    a = col_threads(p)
    n, rows = a["n"], a["rows"]
    used = n > 0
    # chunk (row, column chunk) read once each, with the values up to C
    key = rows[used] * (-(-C // CHUNK)) + np.broadcast_to(a["col"][:, None], n.shape)[used] // CHUNK
    assert np.array_equal(np.sort(key), np.arange(R * -(-C // CHUNK)))
    col = np.broadcast_to(a["col"][:, None], n.shape)[used]
    assert np.array_equal(n[used], np.minimum(CHUNK, C - col))
    # by the block of its band and its slab
    assert (np.broadcast_to(a["by"][:, None], n.shape)[used] == col // BAND).all()
    assert (np.broadcast_to(a["bx"][:, None], n.shape)[used] == rows[used] // (STEP * p["np"])).all()
    # one writer of each column's state
    assert np.array_equal(np.sort(a["state_col"]), np.arange(C))
    if p["G"] > 1:
        G = p["G"]
        off = rows[used] * C + col
        assert (n[used] % G == 0).all()
        width = min(G * BYTES[dt], 16)
        assert ((x_addr + off * BYTES[dt]) % width == 0).all() and (off % G == 0).all()
    return p


def reduce_cols(p, x):
    """The kernel's column absmax of x (R, C): each thread's 8 maxima over
    its chunks, the xor shuffles over lanes 4, 8, 16 apart, lanes 0-3's
    into red[warp][8 lane + e], the 8 warps' into the slab's, and the
    cluster's slabs read in rank order."""
    a = col_threads(p)
    R, C = x.shape
    xp = np.zeros((R + STEP * COL_CHUNKS * MAX_CLUSTER, C + BAND), np.float32)
    xp[:R, :C] = np.abs(x)
    rows, n = a["rows"], a["n"]
    e = np.arange(CHUNK)
    vals = xp[rows[:, :, None], a["col"][:, None, None] + e[None, None, :]]   # (threads, j, e)
    vals = np.where(e[None, None, :] < n[:, :, None], vals, 0.0)
    m = vals.max(1).reshape(p["slabs"], p["bands"], THREADS // 32, 32, CHUNK)
    lane = np.arange(32)
    for o in (4, 8, 16):
        m = np.maximum(m, m[..., lane ^ o, :])
    assert BAND_CHUNKS == 4 and STEP == THREADS // BAND_CHUNKS
    red = m[..., :BAND_CHUNKS, :].reshape(p["slabs"], p["bands"], THREADS // 32, BAND)
    slab = red.max(2)                                    # threads t < 32: column t
    band = slab.max(0).reshape(-1)[:C]                   # every rank's
    return np.maximum(band, np.float32(1e-12))


def reduce_rows(p, x):
    """The kernel's row absmax: each thread's max, the warp's xor shuffles,
    the group's warps' maxima (groups above a warp)."""
    B, K = x.shape
    g, t, at = row_threads(p)
    out = np.zeros(B, np.float32)
    for blk in range(p["blocks"]):
        row, col, n, _ = at(blk)
        e = np.arange(CHUNK)
        idx = np.minimum(col[:, :, None] + e[None, None, :], K - 1)
        vals = np.abs(x[np.minimum(row, B - 1)[:, None, None], idx])
        vals = np.where(e[None, None, :] < n[:, :, None], vals, 0.0)
        m = vals.max((1, 2)).reshape(-1, 32)
        for o in (16, 8, 4, 2, 1):
            m = np.maximum(m, m[:, np.arange(32) ^ o])
        per_warp = m[:, 0]
        wpg = 1 << max(p["gshift"] - 5, 0)
        grp = per_warp.reshape(-1, wpg).max(1)
        live = row[:: 1 << p["gshift"]] < B
        out[row[:: 1 << p["gshift"]][live]] = grp[live]
    return np.maximum(out, np.float32(1e-12))


COL_EDGE_R = (1, 17, 588, 1025, 5120, 8193)
COL_EDGE_C = (1, 33, 70, 1024, 1280, 5120)
# (R, C) of col_quantize on the paths: every CLIP weight as (K, M)
COL_PATH = [(1280, 1280), (1280, 5120), (5120, 1280), (1024, 1024), (1024, 4096),
            (4096, 1024), (588, 1280)]


@pytest.mark.parametrize("C", COL_EDGE_C)
@pytest.mark.parametrize("R", COL_EDGE_R)
def test_col_quantize_reads_each_value_once_at_the_edges(R, C):
    for x_addr, dt in ((0, "bf16"), (2, "bf16"), (8, "bf16"), (0, "f32"), (4, "f32")):
        p = check_cols(R, C, x_addr, dt)
    assert p["wide"] == (R > STEP * COL_CHUNKS * MAX_CLUSTER)


@pytest.mark.parametrize("R,C", COL_PATH)
def test_col_quantize_reads_each_value_once_on_the_paths(R, C):
    p = check_cols(R, C)
    assert p["G"] == 8 and not p["wide"]
    # as few slabs as hold 8 chunk steps (512 rows) each, the rows spread
    # evenly over them
    assert (p["slabs"], p["np"]) == {1280: (3, 7), 5120: (10, 8), 1024: (2, 8), 4096: (8, 8),
                                     588: (2, 5)}[R]


@pytest.mark.parametrize("R,C", [(17, 33), (588, 70), (1025, 1280), (5120, 100), (70, 2049)])
def test_the_reductions_give_ref_absmax_and_codes(R, C):
    """The kernels' reductions on random values (many binades, an all-zero
    row and column, a lone outlier in the last row) give the plain
    versions' states, and the codes from them (IEEE division, product,
    round half to even) their codes."""
    rng = np.random.default_rng(R * 7 + C)
    x = (rng.standard_normal((R, C)) * np.exp(rng.uniform(-4, 4, (R, 1)))).astype(np.float32)
    x[min(2, R - 1)] = 0.0
    x[:, min(2, C - 1)] = 0.0
    x[-1, min(3, C - 1)] = 1000.0
    xt = torch.from_numpy(x)
    q, s = REF.col_quantize(xt)
    a = reduce_cols(col_plan(R, C), x)
    np.testing.assert_array_equal(a, s.numpy()[0])
    codes = np.rint(x * (np.float32(127.0) / a)[None, :]).astype(np.int8)
    np.testing.assert_array_equal(codes, q.numpy())
    q, s = REF.row_quantize(xt)
    a = reduce_rows(row_plan(R, C), x)
    np.testing.assert_array_equal(a, s.numpy()[:, 0])
    np.testing.assert_array_equal(np.rint(x * (np.float32(127.0) / a)[:, None]).astype(np.int8),
                                  q.numpy())


def test_the_row_groups_and_the_reductions_at_wider_rows():
    """Two- to eight-warp groups: the warps' maxima meet per group."""
    rng = np.random.default_rng(3)
    for K in (2049, 4100, 9000, 16384):
        x = rng.standard_normal((9, K)).astype(np.float32)
        x[4, -1] = 50.0
        p = row_plan(9, K)
        assert p["gshift"] == {2049: 6, 4100: 7, 9000: 8, 16384: 8}[K]
        np.testing.assert_array_equal(reduce_rows(p, x), REF.row_quantize(torch.from_numpy(x))[1]
                                      .numpy()[:, 0])
