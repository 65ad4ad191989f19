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
