"""The tensor quantizers' work split, modelled in numpy (no card, no JAX;
a few seconds).

``kernels/csrc/tensor_absmax.cuh`` is the one skeleton of the int8
``tensor_quantize`` (``kernels/switchback``) and the fp8 one
(``kernels/fp8_matmul``). Its launcher (``make_plan``) takes one
cooperative launch where the tensor fits the registers of the blocks that
can be resident at once, and two launches (a max pass, then a cast pass
that reads x again) past that. Block b owns the chunks of 8 values
[b C / B, (b + 1) C / B) of the flat tensor; thread t of it holds chunks
t, t + 256, ... of its span (at most ``max_chunks``), loaded in granules
of G values (``granule``: by x's and q's alignment), the last chunk value
by value where n % 8 != 0.

The model repeats the launcher's choices (the granule, the grid, one launch
or two and the rounds) for a given occupancy, and every thread's index
arithmetic, and checks at the edge sizes of ``chip_smoke.py``'s phases 13
and 19 and at every weight of the serve and train paths (smollm's seven a
layer, CLIP's vision and text layers' six, the patch embedding): each value
of x is read by exactly one thread and its byte written once, from the same
registers, in whole aligned granules but for the ragged tail; every path
weight in bf16 takes the one launch at the two blocks an SM the kernels'
launch bounds guarantee. It also runs the reduction (each block's max over
its span, then every block's reduction of all partials) on random values and
holds the absmax, and the codes from it, to the plain versions in both
families' ``ref.py``; leaving out the partial of the absmax's block (the
checks' control fault) changes the state whenever there is more than one
block.

The fp8 K-major form (``tensor_quantize_kt``: the codes row-major and,
K-major, the forward GEMMs' W, from the same registers) splits x into 2-D
tiles instead, one a block (``make_tile_plan``). Its model repeats the
launcher's tile choice and every thread's loads, stores, staging and
transposed 4 x 4-byte moves, and checks at every path weight, the patch
embedding and the ragged 37 x 5 and 130 x 70: the grid within the resident
blocks (every path weight in bf16 on the one launch), each value read once,
each K-major byte written once and equal to q's transposed byte, runs of
at least 32 bytes of a K-major row wherever K allows, the tile inside the
registers and the stage, the transposed reads free of bank conflicts.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.fp8_matmul import ops as F8OPS
from repro_torch.kernels.fp8_matmul import ref as F8REF
from repro_torch.kernels.switchback import ops as SBOPS
from repro_torch.kernels.switchback import ref as SBREF

torch.set_num_threads(1)

KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
SRC = (KERNELS / "csrc" / "tensor_absmax.cuh").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


THREADS, CHUNK, MAX_PARTIALS = _const("kThreads"), _const("kChunk"), _const("kMaxPartials")
_MC = re.search(r"return sizeof\(T\) == 2 \? (\d+) : (\d+);", SRC)
MAX_CHUNKS = {"bf16": int(_MC.group(1)), "f32": int(_MC.group(2))}
BYTES = {"bf16": 2, "f32": 4}
SMS = 132
# the kernels' __launch_bounds__(256, 2) (both families): at most 128
# registers a thread, so at least two blocks an SM
_BOUNDS = {int(m) for f in ("switchback/csrc/switchback.cu", "fp8_matmul/csrc/fp8_matmul.cu")
           for m in re.findall(r"__launch_bounds__\(tq::kThreads, (\d+)\)",
                               (KERNELS / f).read_text())}
assert len(_BOUNDS) == 1
MIN_PER_SM = _BOUNDS.pop()

# every weight (K, M) of the serve and train paths
DECODE = [(960, 960), (960, 320), (960, 2560), (2560, 960)]       # wq/wo, wk/wv, up/gate, down
CLIP_VISION = [(1280, 1280), (1280, 5120), (5120, 1280)]
CLIP_TEXT = [(1024, 1024), (1024, 4096), (4096, 1024)]
PATCH_EMBED = [(588, 1280)]
PATH = DECODE + CLIP_VISION + CLIP_TEXT + PATCH_EMBED
# ragged and small n (phase 13's and the cuda tests' edges)
EDGES = [1, 7, 8, 9, 15, 2048, 2049, 65541, 700021, 1024 * 1024 + 3]


def granule(x_addr, q_addr, dt):
    """``granule``: the largest G in {8, 4, 2} whose loads (G values of x,
    at most 16 bytes) and stores (G bytes of q) are aligned, else 1."""
    for G in (8, 4, 2):
        if x_addr % min(G * BYTES[dt], 16) == 0 and q_addr % G == 0:
            return G
    return 1


def plan(n, resident, dt="bf16", x_addr=0, q_addr=0):
    """``make_plan``: the grid, one launch (rounds 0) or the two passes'
    rounds, the granule."""
    chunks = -(-n // CHUNK)
    per_block = THREADS * MAX_CHUNKS[dt]
    cap = max(1, min(resident, MAX_PARTIALS))
    blocks = min(max(1, -(-chunks // THREADS)), cap)
    span = -(-chunks // blocks)
    rounds = 0 if span <= per_block else -(-span // per_block)
    return dict(n=n, chunks=chunks, blocks=blocks, rounds=rounds, dt=dt,
                G=granule(x_addr, q_addr, dt), x_addr=x_addr, q_addr=q_addr)


def limit(resident, dt):
    """The most values the one launch takes: every resident block's round."""
    return resident * THREADS * MAX_CHUNKS[dt] * CHUNK


def chunk_grid(p):
    """Per (block, thread, round, j) the chunk it loads, or -1: block b's
    thread t takes chunk lo_b + t + 256 (r K + j) while it lies below hi_b."""
    K = MAX_CHUNKS[p["dt"]]
    b = np.arange(p["blocks"], dtype=np.int64)
    lo, hi = b * p["chunks"] // p["blocks"], (b + 1) * p["chunks"] // p["blocks"]
    rounds = max(1, p["rounds"])
    t = np.arange(THREADS, dtype=np.int64)
    step = np.arange(rounds * K, dtype=np.int64) * THREADS           # round r, j: r K + j
    c = lo[:, None, None] + t[None, :, None] + step[None, None, :]
    return np.where(c < hi[:, None, None], c, -1), lo, hi


def check_layout(p):
    """Every value read once and its byte written once by the thread that
    holds it, in aligned granules but for the ragged tail; each block's span
    inside its registers in one launch (rounds 0) or covered by its rounds."""
    c, lo, hi = chunk_grid(p)
    n = p["n"]
    assert (np.diff(np.concatenate([lo, hi[-1:]])) >= 0).all() and hi[-1] == p["chunks"]
    assert (hi - lo).max() - (hi - lo).min() <= 1                     # even spans
    live = c[c >= 0]
    assert np.array_equal(np.sort(live), np.arange(p["chunks"]))     # each chunk once
    first = live * CHUNK
    count = np.minimum(CHUNK, n - first)
    assert (count[live != n // CHUNK] == CHUNK).all()                # only the tail is short
    assert count.sum() == n                                          # each value once
    # the tail's values load and store one by one; every other chunk in
    # granules of G, aligned in x and in q
    whole = live[live != n // CHUNK] if n % CHUNK else live
    G, size = p["G"], BYTES[p["dt"]]
    assert ((p["x_addr"] + whole * CHUNK * size) % min(G * size, 16) == 0).all()
    assert ((p["q_addr"] + whole * CHUNK) % G == 0).all()
    if p["rounds"] == 0:                   # the one launch: a thread holds its whole share
        assert (c[:, :, MAX_CHUNKS[p["dt"]]:] < 0).all()
    assert p["blocks"] <= MAX_PARTIALS
    return c


@pytest.mark.parametrize("per_sm", [MIN_PER_SM, 3, 4])
@pytest.mark.parametrize("K,M", PATH)
def test_every_path_weight_takes_the_one_launch_in_bf16(K, M, per_sm):
    p = plan(K * M, per_sm * SMS)
    assert p["rounds"] == 0, (K, M, p)
    check_layout(p)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("K,M", PATH)
def test_path_weights_read_each_value_once(K, M, dt):
    check_layout(plan(K * M, MIN_PER_SM * SMS, dt))


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("n", EDGES)
@pytest.mark.parametrize("offset", [0, 1, 2, 4])
def test_edges_read_each_value_once(n, offset, dt):
    """Ragged and small n from every offset (every granule)."""
    p = plan(n, MIN_PER_SM * SMS, dt, x_addr=256 + offset * BYTES[dt])
    assert p["G"] == {0: 8, 1: 1, 2: 2, 4: 4 if dt == "bf16" else 8}[offset]
    check_layout(p)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("per_sm", [MIN_PER_SM, 3])
def test_one_launch_ends_at_the_registers(per_sm, dt):
    """One granule either side of the limit, and the limit: at it one
    launch, past it the two passes in two rounds of a block's span."""
    resident = per_sm * SMS
    L = limit(resident, dt)
    for n, rounds in ((L - 8, 0), (L - 3, 0), (L, 0), (L + 8, 2)):
        p = plan(n, resident, dt)
        assert p["rounds"] == rounds and p["blocks"] == resident, (n, p)
        check_layout(p)


def test_granules():
    assert [granule(256 + o * 2, 0, "bf16") for o in (0, 1, 2, 4)] == [8, 1, 2, 4]
    assert [granule(256 + o * 4, 0, "f32") for o in (0, 1, 2, 4)] == [8, 1, 2, 8]
    assert granule(256, 4, "bf16") == 4 and granule(256, 1, "bf16") == 1


def test_wrappers_partials_match_the_launcher():
    """The wrappers' partial buffers hold the most blocks the launcher
    takes."""
    assert SBOPS.MAX_PARTIALS == MAX_PARTIALS == F8OPS.MAX_PARTIALS


def reduce(p, x):
    """The kernels' reduction on the flat float32 values x: each block's
    max over the values of its span, then max over every block's partial
    (all but ``drop``), floored at 1e-12."""
    c, lo, hi = chunk_grid(p)
    a = np.abs(x.astype(np.float32))
    part = np.array([a[CHUNK * l:min(CHUNK * h, p["n"])].max() if h > l else 0.0
                     for l, h in zip(lo, hi)], dtype=np.float32)
    # the same maxima from the threads' chunks (the shuffles' and the
    # warps' order does not change a max)
    for b in {0, p["blocks"] - 1}:
        mine = c[b][c[b] >= 0]
        vals = a[(mine[:, None] * CHUNK + np.arange(CHUNK)).clip(max=p["n"] - 1)]
        assert vals.max() == part[b]
    return part


@pytest.mark.parametrize("n", [9, 2049, 65541, 960 * 320, 1280 * 5120, 588 * 1280])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_the_reduction_gives_ref_absmax_and_codes(n, dt):
    """Both families: the model's absmax is the plain version's state, the
    codes from it are the plain version's codes; leaving out the absmax's
    block's partial changes the state wherever there are two blocks or
    more."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-4, 4, n))).astype(np.float32)
    at = int(rng.integers(n))
    x[at] = -2 * np.abs(x).max()
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    xt = torch.from_numpy(x).to(tdt).reshape(1, n)
    xf = xt.float().numpy().reshape(-1)
    p = plan(n, MIN_PER_SM * SMS, dt)
    part = reduce(p, xf)
    absmax = np.float32(max(part.max(), np.float32(1e-12)))
    am = torch.tensor([[absmax]])
    q, s = SBREF.tensor_quantize(xt)
    assert float(s) == absmax
    assert torch.equal(torch.round(xt.float() * SBREF.div(127.0, am)).to(torch.int8), q)
    for fmt in ("e4m3", "e5m2"):
        q8, s8 = F8REF.tensor_quantize(xt, fmt)
        assert float(s8) == absmax
        assert torch.equal(F8REF.cast(xt, am, fmt).view(torch.uint8), q8.view(torch.uint8))
    if p["blocks"] > 1:
        owner = int(np.searchsorted(chunk_grid(p)[1], at // CHUNK, side="right")) - 1
        assert np.delete(part, owner).max() < absmax


def test_cpu_tensors_take_the_plain_versions_and_the_fault_needs_the_card():
    """On the CPU both wrappers return their plain versions' bits; the
    checks' control-fault entry points launch the kernel, so they refuse a
    CPU tensor."""
    x = (torch.randn(37, 130, generator=torch.Generator().manual_seed(3)) * 5).bfloat16()
    for got, want in ((SBOPS.tensor_quantize(x), SBREF.tensor_quantize(x)),
                      (F8OPS.tensor_quantize(x, "e5m2"), F8REF.tensor_quantize(x, "e5m2"))):
        assert torch.equal(got[0].view(torch.uint8), want[0].view(torch.uint8))
        assert torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        SBOPS.tensor_quantize_drop(x, 0)
    with pytest.raises(ValueError):
        F8OPS.tensor_quantize_drop(x, "e4m3", 0)


# ---------------------------------------------------------------------------
# The K-major form (the fp8 ``tensor_quantize_kt``): block b owns tile b of
# a grid of h x w tiles of x (R, C); the codes go row-major into q and,
# through a staging buffer of odd-word pitch, K-major into q_k (C, R).
# ---------------------------------------------------------------------------

TILE_ROWS, TILE_COLS = _const("kTileRows"), _const("kTileCols")
MAX_TILE_ROWS = _const("kMaxTileRows")
assert re.search(r"constexpr int kStageWords = kThreads \* max_chunks<__nv_bfloat16>\(\) \* "
                 r"kChunk / 4 \+ kMaxTileRows;", SRC)
STAGE_WORDS = THREADS * MAX_CHUNKS["bf16"] * CHUNK // 4 + MAX_TILE_ROWS
WARPS = THREADS // 32
# the K-major form's ragged shapes (the cuda tests' transpose cases)
KT_RAGGED = [(37, 5), (130, 70)]


def _up(a, b):
    return -(-a // b) * b


def plan_kt(R, C, resident, dt="bf16", x_addr=0, q_addr=0, qk_addr=0):
    """``make_tile_plan``: the tile (h, w) of least h w whose grid fits the
    blocks and whose values fit the registers (the squarer on a tie), or
    the two passes' tile; the granule (``granule_kt``)."""
    G = granule(x_addr, q_addr, dt)
    while G > 1 and C % G:
        G //= 2
    cap = max(1, min(resident, MAX_PARTIALS))
    vals = THREADS * MAX_CHUNKS[dt] * CHUNK
    hmax, wmax = min(MAX_TILE_ROWS, _up(R, TILE_ROWS)), _up(C, TILE_COLS)
    best, h, w = 0, 0, 0
    for hh in range(TILE_ROWS, hmax + 1, TILE_ROWS):
        nr = -(-R // hh)
        ncmax = cap // nr
        if ncmax == 0:
            continue
        ww = min(wmax, _up(-(-C // ncmax), TILE_COLS))
        if hh * ww > vals:
            continue
        if best == 0 or hh * ww < best or (hh * ww == best and min(hh, ww) > min(h, w)):
            best, h, w = hh * ww, hh, ww
    if best == 0:
        h = min(128, hmax)
        w = min(wmax, vals // h // TILE_COLS * TILE_COLS)
    nc = -(-C // w)
    tiles = -(-R // h) * nc
    blocks = max(1, min(tiles, cap))
    cw = w // CHUNK
    return dict(R=R, C=C, h=h, w=w, nc=nc, tiles=tiles, blocks=blocks,
                rounds=0 if best else -(-tiles // blocks), G=G, dt=dt, cw=cw,
                dr=THREADS // cw, dc=THREADS % cw, pitch=w // 4 + 1,
                kwords=qk_addr % 4 == 0 and R % 4 == 0, x_addr=x_addr, q_addr=q_addr,
                qk_addr=qk_addr)


def kt_tiles(p):
    """(r0, c0, rows, cols) of every tile, row-major over the grid."""
    for t in range(p["tiles"]):
        tr, tc = divmod(t, p["nc"])
        r0, c0 = tr * p["h"], tc * p["w"]
        yield r0, c0, min(p["h"], p["R"] - r0), min(p["w"], p["C"] - c0)


def kt_chunks(p):
    """Each thread's (row, chunk) of its tile for j = 0 .. kMaxChunks - 1
    (rows (THREADS, K)): from divmod(t, cw), stepped by divmod(256, cw)
    with a carry, as load_tile and store_tile step them."""
    K = MAX_CHUNKS[p["dt"]]
    t = np.arange(THREADS)
    r, c = t // p["cw"], t % p["cw"]
    rows, cols = np.empty((THREADS, K), np.int64), np.empty((THREADS, K), np.int64)
    for j in range(K):
        rows[:, j], cols[:, j] = r, c
        r, c = r + p["dr"], c + p["dc"]
        wrap = c >= p["cw"]
        c, r = np.where(wrap, c - p["cw"], c), np.where(wrap, r + 1, r)
    i = t[:, None] + THREADS * np.arange(K)[None, :]              # the chunk's index
    assert np.array_equal(rows, i // p["cw"]) and np.array_equal(cols, i % p["cw"])
    return rows, cols


def kt_cells(p):
    """Per warp, the cells (ca, cb) it walks: warp, warp + 8, ... as
    store_tile steps ca by 8 and wraps it into cb."""
    cells_r, cells = p["h"] // 32, (p["h"] // 32) * (p["w"] // 16)
    out = []
    for warp in range(WARPS):
        ca, cb, mine = warp, 0, []
        while ca >= cells_r:
            ca, cb = ca - cells_r, cb + 1
        for cell in range(warp, cells, WARPS):
            assert (ca, cb) == (cell % cells_r, cell // cells_r)
            mine.append((ca, cb))
            ca += WARPS
            while ca >= cells_r:
                ca, cb = ca - cells_r, cb + 1
        out.append(mine)
    return out


def banks(words):
    """Wavefronts of one shared-memory access of a warp: the most distinct
    words on one bank (a word read by several lanes is one)."""
    words = np.unique(np.asarray(words))
    return int(np.bincount(words % 32).max()) if words.size else 0


def kt_tile_model(p, nrow, ncol):
    """One tile of nrow x ncol (of h x w) through every thread of its
    block, in tile coordinates: the values read ((row, column) pairs, and
    the whole chunks' starts), the staged bytes, the K-major bytes written
    ((column, row) and the staged value they carry, and the starts of the
    4-byte words) and the worst wavefronts of the stage's stores and of its
    transposed reads."""
    h, w, P = p["h"], p["w"], p["pitch"]
    rows, cols = kt_chunks(p)
    col = CHUNK * cols
    live = (rows < nrow) & (col < ncol)
    m = np.minimum(CHUNK, ncol - col)
    e = np.arange(CHUNK)
    inside = live[..., None] & (e < m[..., None])
    rr = np.broadcast_to(rows[..., None], inside.shape)[inside]
    cc = (col[..., None] + e)[inside]
    whole = live & (m == CHUNK)
    out = dict(read_r=rr, read_c=cc, whole_r=rows[whole], whole_c=col[whole],
               tail=live & (m < CHUNK))
    # the stage: byte b of staged row r holds the tile's value (r, b)
    stage = np.full(h * P * 4, -2, np.int64)
    warp, half = np.arange(THREADS) // 32, (np.arange(THREADS) >> 4) & 1
    worst_st = 0
    for j in range(rows.shape[1]):
        lv = live[:, j]
        w0 = rows[:, j] * P + 2 * cols[:, j]
        assert (w0[lv] == 2 * (rows[lv, j] * p["cw"] + cols[lv, j]) + rows[lv, j]).all()
        odd = (rows[:, j] ^ half) & 1                   # the first store's word
        for word in (w0 + odd, w0 + 1 - odd):
            for wv in range(WARPS):
                worst_st = max(worst_st, banks(word[lv & (warp == wv)]))
        for b in range(CHUNK):
            ok = lv & (b < m[:, j])
            at = 4 * w0[ok] + b
            assert (stage[at] == -2).all()
            stage[at] = rows[ok, j] * w + col[ok, j] + b
    ln = np.arange(32)
    kc, kr, kv, words, worst_ld = [], [], [], [], 0
    for mine in kt_cells(p):
        for ca, cb in mine:
            row = 4 * (8 * ca + (ln & 7))
            blk = 4 * cb + (ln >> 3)
            c = 4 * blk
            ok = (row < nrow) & (c < ncol)
            for k in range(4):
                worst_ld = max(worst_ld, banks(((row + k) * P + blk)[ok]))
            for i in range(4):
                for k in range(4):
                    put = ok & (c + i < ncol) & (row + k < nrow)
                    kc.append(c[put] + i)
                    kr.append(row[put] + k)
                    kv.append(stage[4 * ((row[put] + k) * P + blk[put]) + i])
                full = ok & (c + i < ncol) & (row + 4 <= nrow)
                words.append(np.stack([c[full] + i, row[full]], 1))
    out.update(k_c=np.concatenate(kc), k_r=np.concatenate(kr), k_v=np.concatenate(kv),
               words=np.concatenate(words), worst_st=worst_st, worst_ld=worst_ld)
    return out


def check_kt_layout(p):
    """Model every thread of every block: each value read once (granules
    aligned but for the ragged tail at x's right edge), its code written
    once into q and staged, each byte of q_k written once from the staged
    code of q's transposed position, in runs of min(h, R - r0) bytes
    (4-byte words where ``kwords`` and the block is whole, aligned); the
    tile within the registers and the stage, the stage's transposed reads
    free of bank conflicts and its stores at most 2 wavefronts. Tiles of
    one size share the model (their offsets differ). Returns the worst
    wavefronts (stage stores, reads)."""
    R, C, dt = p["R"], p["C"], p["dt"]
    size, G = BYTES[dt], p["G"]
    assert p["h"] % TILE_ROWS == 0 and p["w"] % TILE_COLS == 0
    assert p["h"] * p["w"] <= THREADS * MAX_CHUNKS[dt] * CHUNK           # the registers
    assert p["h"] * p["pitch"] <= STAGE_WORDS and p["pitch"] % 2 == 1
    assert p["blocks"] <= MAX_PARTIALS
    if p["rounds"] == 0:
        assert p["blocks"] == p["tiles"]
    else:
        assert p["rounds"] * p["blocks"] >= p["tiles"]
    tiles = np.array(list(kt_tiles(p)), np.int64)                    # (r0, c0, rows, cols)
    read = np.zeros(R * C, np.int64)
    written = np.zeros(C * R, np.int64)
    worst = [0, 0]
    for nrow, ncol in {(int(a), int(b)) for a, b in tiles[:, 2:]}:
        mine = tiles[(tiles[:, 2] == nrow) & (tiles[:, 3] == ncol)]
        r0, c0 = mine[:, :1], mine[:, 1:2]
        t = kt_tile_model(p, nrow, ncol)
        worst = [max(worst[0], t["worst_st"]), max(worst[1], t["worst_ld"])]
        read += np.bincount(((r0 + t["read_r"]) * C + c0 + t["read_c"]).ravel(),
                            minlength=R * C)
        assert not t["tail"].any() or (c0 + ncol == C).all()           # tails at x's edge
        start = (r0 + t["whole_r"]) * C + c0 + t["whole_c"]
        assert ((p["x_addr"] + start * size) % min(G * size, 16) == 0).all()
        assert ((p["q_addr"] + start) % G == 0).all()
        # q_k's byte (c, r) carries the staged value of (r, c)
        assert np.array_equal(t["k_v"], t["k_r"] * p["w"] + t["k_c"])
        written += np.bincount(((c0 + t["k_c"]) * R + r0 + t["k_r"]).ravel(), minlength=R * C)
        if p["kwords"]:
            d = (c0 + t["words"][:, 0]) * R + r0 + t["words"][:, 1]
            assert ((p["qk_addr"] + d) % 4 == 0).all()
    assert (read == 1).all()                                       # every value once
    assert (written == 1).all()                                    # every K-major byte once
    for r0, _, nrow, _ in tiles:       # a tile's run in each K-major row: >= 32 bytes but x's last
        assert nrow == min(p["h"], R - r0) and (nrow >= TILE_ROWS or r0 + nrow == R)
    assert worst[1] <= 1 and worst[0] <= 2
    return tuple(worst)


KT_SHAPES = PATH + KT_RAGGED


@pytest.mark.parametrize("K,M", PATH)
def test_kt_every_path_weight_takes_the_one_launch_on_every_resident_block(K, M):
    """In bf16 at the two blocks an SM of the launch bounds, every path
    weight takes the one launch, a tile a block, its grid within the
    resident blocks and, where the weight has them, at least 200 blocks
    (not the 50 of 128 x 256 tiles at a 1,280 x 1,280 weight)."""
    resident = MIN_PER_SM * SMS
    p = plan_kt(K, M, resident)
    assert p["rounds"] == 0 and p["tiles"] == p["blocks"] <= resident, p
    assert p["blocks"] >= min(200, -(-K * M // (THREADS * CHUNK))), p


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("K,M", KT_SHAPES)
def test_kt_reads_each_value_once_and_writes_each_k_major_byte_once(K, M, dt):
    p = plan_kt(K, M, MIN_PER_SM * SMS, dt)
    assert p["blocks"] <= MIN_PER_SM * SMS
    check_kt_layout(p)


@pytest.mark.parametrize("K,M,offset", [(37, 5, 1), (130, 70, 1), (130, 70, 2), (588, 1280, 4),
                                        (960, 320, 1)])
def test_kt_unaligned_bases_take_smaller_granules(K, M, offset):
    """From a base off 16 bytes, or a width off the granule, every whole
    chunk still loads and stores aligned granules."""
    p = plan_kt(K, M, MIN_PER_SM * SMS, "bf16", x_addr=256 + 2 * offset)
    assert p["G"] == max(g for g in (1, 2, 4, 8) if (2 * offset) % min(2 * g, 16) == 0
                         and M % g == 0)
    check_kt_layout(p)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_kt_two_passes_past_the_registers(dt):
    """A tensor whose tile grid exceeds the blocks at every tile that fits
    takes the two passes, each block walking its tiles in rounds (a small
    occupancy, so that the model stays quick)."""
    p = plan_kt(300, 700, 2, dt)
    assert p["rounds"] > 0 and p["blocks"] == 2
    check_kt_layout(p)
    assert plan_kt(5120, 1280, MIN_PER_SM * SMS, "f32")["rounds"] > 0      # f32 past ~4.3 M


def test_kt_plan_picks_the_least_tile_and_the_squarer_on_a_tie():
    """The vision layer's weights at 264 blocks: 1,280 x 1,280 on 240 tiles
    of 64 x 112 (32 x 224 holds as many values); 1,280 x 5,120 and 5,120 x
    1,280 on 256 tiles of 160 x 160."""
    at = lambda K, M: {k: plan_kt(K, M, 264)[k] for k in ("h", "w", "tiles")}
    assert at(1280, 1280) == dict(h=64, w=112, tiles=240)
    assert at(1280, 5120) == dict(h=160, w=160, tiles=256)
    assert at(5120, 1280) == dict(h=160, w=160, tiles=256)


@pytest.mark.parametrize("n", [1280 * 1280, 1280 * 5120, 588 * 1280])
def test_kt_reduction_is_the_flat_forms(n):
    """The tile split changes which block holds a value, not the maximum:
    the K-major form's partials reduce to the flat form's absmax."""
    K = {1280 * 1280: 1280, 1280 * 5120: 1280, 588 * 1280: 588}[n]
    M = n // K
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((K, M)) * np.exp(rng.uniform(-4, 4, (K, M)))).astype(np.float32)
    x[K - 1, M - 1] = -3 * np.abs(x).max()
    p = plan_kt(K, M, MIN_PER_SM * SMS)
    part = np.array([np.abs(x[r0:r0 + nr, c0:c0 + nc]).max() for r0, c0, nr, nc in kt_tiles(p)])
    flat = reduce(plan(n, MIN_PER_SM * SMS), x.reshape(-1))
    assert part.max() == flat.max() == np.abs(x).max()
