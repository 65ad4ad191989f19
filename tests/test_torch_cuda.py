"""The port's CUDA kernels on the card (marker ``cuda``).

These tests import no JAX, so they run on a machine with the card and
without JAX (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py

Elsewhere they skip. Each SwitchBack kernel, forward and input gradient,
must be bit-equal to its plain PyTorch version
(``kernels/switchback/ref.py``) on the same inputs at the serve and train
paths' shapes (the fused pair also either side of its one-launch form's
16 rows, on all-zero rows and twice the same bits); each flash-attention
forward kernel must agree with its plain version
(``kernels/flash_attention/ref.py``, one full softmax where the kernel
takes an online one) within o 2^-7 of max|o| in bf16 (one bf16
ulp at the largest value) and 1e-5 in f32, lse 1e-5 absolute; the two
backward kernels within BWD_TOL of max|grad| of theirs (the same
recomputed p, sums in another order), and bit-identical over two
launches. The fp8 kernels (``kernels/fp8_matmul``): the three quantizers
bit-equal to their plain versions (``kernels/fp8_matmul/ref.py``) at every
fp8 path shape and the warp-a-row path's K edges, on ties, ±0, subnormals,
all-zero rows and tiles, from an odd offset too, twice the same bits; their
byte conversion equal to grid_round + encode on every f32 and their bf16
division to ``__fdiv_rn``'s bytes on every pair it meets;
``fp8_matmul_dequant`` and ``fp8_mixed_matmul`` in both orientations (fp8
wgmma, whose sums keep 13 bits below their largest addend) within
``ref.matmul_bound`` of theirs per output, bit-identical over two
launches, and bit-equal on ``ref.exact_entries`` inputs, where every
window sum is exact at that width. A CUDA tensor must go to the kernel,
never to the plain version.
The paged-attention kernels (``kernels/paged_attention``) within O_TOL of
their plain versions (one gather-then-dense softmax) at the paged serve
path's shapes, with dead table entries outside the pool and a dry slot
giving exact zeros; each prefill row bit-equal to the decode at the same
position (the property that makes speculative verify and preemption
recompute give a plain decode's tokens), and every kernel bit-identical
over two launches.
The paged kernels and all four flash kernels run on the tensor cores
through one tile step (mma.sync, operands split into bf16 terms, every k16
step a fresh fragment); a paged prefill row's bits equal the decode's at
every row for Sq 5 and 128. ``flash_fwd`` also at CLIP's hd 64 and 80 and
Sq off the multiples of 16 and 64, and with both backward kernels at
smollm's, CLIP's, internvl2's and seamless's attention shapes (cross
attention's Sq != Sk: 64 and 1 queries over 4,096 frames), twice the same
bits;
``decode_fwd`` (split-key) at every dtype pair, groups up to 8, hd 64, 80
and 128, S_max off its part and kv_len 0, twice the same bits.
``int8_matmul_dequant`` (int8 wgmma) in all four forms (row or column
scale, W (K, M) or (M, K)) bit-equal to its plain version at the paths'
shapes, the swapped decode form, the masked producer (K = 588) and the
widest s32 sums (all-±127 operands at K = 5,120). ``row_quantize`` and
``col_quantize`` (read once into registers; the column kernel a thread
block cluster a band) bit-equal to their plain versions at their paths'
edges, from aligned and unaligned bases. The int8 and fp8
``tensor_quantize`` (one cooperative launch: x read once into the resident
blocks' registers, their maxima met at one grid barrier) bit-equal to
their plain versions at every path weight, ragged n and the one-launch
limit's edges, from every granule's offset, the control fault (the
absmax's block's partial left out) caught; a captured CUDA graph replays
to the same bytes; one CUDA kernel a call on every path weight. The fp8
forward's K-major W from the quantizer (``tensor_quantize_kt``): q and the
state ``tensor_quantize``'s bits, q_k ``transpose_bytes``' bytes, one CUDA
kernel a call, the forwards given it bit-equal to those through
``transpose_bytes``, its control faults caught.
The two op-entry-point kernels: ``fp8_cast_tensorwise``
(``kernels/fp8_cast``) bit-equal to its plain version, both formats, f32
and bf16 inputs, a pointer off 16-byte alignment, twice the same bits;
``wgrad_bf16`` (bf16 wgmma, windows of 64 rows of B) within
``ref.wgrad_bound`` of its plain version (the in-order f32 sum), bit-equal
to it on exactly summable inputs, bit-equal to the tensor-core model
(``wgmma_model.wgrad_rows``) at ``wgmma_model.check_rows``, twice the same
bits, and within B · 2^-23 · (|x|ᵀ|g|) of cuBLAS (``wgrad_16bit``).
``chip_smoke.py`` runs the same checks inside its end-to-end run.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import switchback as SB
from repro_torch.core.fp8 import SPECS, fp8_values
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.fp8_cast import ops as FC
from repro_torch.kernels.fp8_cast import ref as FCREF
from repro_torch.kernels.flash_attention import ref as FREF
from repro_torch.kernels.fp8_matmul import ops as F8
from repro_torch.kernels.fp8_matmul import ref as F8REF
from repro_torch.kernels.fp8_matmul import wgmma_model as F8TC
from repro_torch.kernels.paged_attention import ops as PA
from repro_torch.kernels.paged_attention import ref as PREF
from repro_torch.kernels.switchback import ops as TOPS
from repro_torch.kernels.switchback import ref as TREF

# flash o vs plain, relative to max|o|: one ulp at the largest value in the
# 16-bit types (2^-7 bf16, 2^-10 f16: both sides compute in f32 and round
# once, now and then on either side of a boundary), 1e-5 in f32
O_TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10, torch.float32: 1e-5}
LSE_TOL = 1e-5
# backward kernels vs plain, relative to max|grad|: the inputs are exact in
# both types and both sides compute in f32, so the gap is the order of f32
# sums over keys and rows (about 1e-6); bf16 and f16 inputs carry the same
BWD_TOL = {torch.bfloat16: 1e-4, torch.float16: 1e-4, torch.float32: 1e-4}
# the flash kernels' forms: bf16, f32 and f16 (the FP16 policy's)
FLASH_DTYPES = [torch.bfloat16, torch.float32, torch.float16]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _activations(rng, B, K):
    """B random rows; from 3 rows on, row 1 holds exact half-way ties and
    row 2 is all zero."""
    x = rng.standard_normal((B, K)).astype(np.float32) * 3
    if B >= 3:
        ties = (np.arange(K, dtype=np.float32) % 8) - 3.5
        ties[0] = 127.0                  # scale 1: every .5 is a tie
        x[1] = ties
        x[2] = 0.0                       # all-zero row
    return torch.from_numpy(x).to(torch.bfloat16)


def _fused_holds(fused, plain, t, w_q, s_w):
    """A fused kernel bit-equal to its plain version on ``t``, twice the
    same bits, and on all-zero rows of the same shape (the absmax floor);
    the one-launch form's K-split workspace left zero."""
    for a in (t, torch.zeros_like(t)):
        want = plain(a, w_q, s_w)
        got = fused(a, w_q, s_w)
        assert got.dtype == a.dtype and torch.equal(got, want)
        assert torch.equal(fused(a, w_q, s_w), got)                     # rerun
    assert not any(bool(b.any()) for b in TOPS._SPLIT.values())


# the fused pair's shapes: smollm's decode (8), prefill (1,024) and train
# (2,048) rows; CLIP's vision (4,128), text (2,464) and patch embedding
# (8,192 x 588); either side of the one-launch form's 16 rows (1, 15, 16,
# 17); ragged; the widest fused contraction (2,048)
@pytest.mark.cuda
@pytest.mark.parametrize("B,K,M", [(8, 960, 320), (8, 2560, 960), (8, 960, 2560),
                                   (1024, 960, 2560), (2048, 960, 960), (37, 130, 70),
                                   (4128, 1280, 1280), (4128, 1280, 5120), (2464, 1024, 1024),
                                   (2464, 1024, 4096), (8192, 588, 1280), (1, 960, 960),
                                   (15, 960, 320), (16, 960, 320), (17, 960, 320),
                                   (8, 2048, 960), (1000, 2048, 960)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_kernels_match_plain(B, K, M, dt):
    dev = _card()
    rng = np.random.default_rng(B * K + M)
    x = _activations(rng, B, K).to(dev, dt)
    w = torch.from_numpy(rng.standard_normal((K, M)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    w_q, s_w = TOPS.tensor_quantize(w)
    rq, rs = TREF.tensor_quantize(w)
    assert torch.equal(w_q, rq) and torch.equal(s_w, rs)
    _fused_holds(TOPS.fused_switchback_fwd, TREF.fused_switchback_fwd, x, w_q, s_w)
    x_q, s_x = TOPS.row_quantize(x)
    rxq, rsx = TREF.row_quantize(x)
    assert torch.equal(x_q, rxq) and torch.equal(s_x, rsx)
    scale = s_x * TREF.div(s_w, 16129.0)
    assert torch.equal(TOPS.int8_matmul_dequant(x_q, w_q, scale, out_dtype=dt),
                       TREF.int8_matmul_dequant(x_q, w_q, scale, out_dtype=dt))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,N", [(2048, 960, 960), (2048, 320, 960), (2048, 960, 2560),
                                   (1000, 2560, 960), (8, 2560, 960), (37, 70, 130),
                                   (4128, 1280, 1280), (4128, 1280, 5120), (2464, 1024, 1024),
                                   (2464, 1024, 4096), (1, 960, 960), (15, 320, 960),
                                   (16, 320, 960), (17, 320, 960), (1000, 2048, 960)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_dgrad_kernels_match_plain(B, M, N, dt):
    """The dgrad pair at the train paths' shapes: g (B, M) against the
    forward's w_q (N, M), contracted over M."""
    dev = _card()
    rng = np.random.default_rng(B * M + N)
    g = _activations(rng, B, M).to(dev, dt)
    w = torch.from_numpy(rng.standard_normal((N, M)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    w_q, s_w = TOPS.tensor_quantize(w)
    _fused_holds(TOPS.fused_switchback_dgrad, TREF.fused_switchback_dgrad, g, w_q, s_w)
    g_q, s_g = TOPS.row_quantize(g)
    scale = s_g * TREF.div(s_w, 16129.0)
    want = TREF.int8_matmul_dequant_t(g_q, w_q, scale, out_dtype=dt)
    got = TOPS.int8_matmul_dequant_t(g_q, w_q, scale, out_dtype=dt)
    assert torch.equal(got, want)
    torch.cuda.synchronize()


# the SSM and hybrid paths' linears (K, M) at their rows: rwkv6-1.6b's
# 2,048 x 2,048 (wr, wk, wv, wg, wo, w_receptance) and 2,048 x 7,168 (w_key,
# w_value) at decode (8) and train (2,048) rows; jamba-v0.1-52b's w_in
# (4,096 -> 16,384), w_x_proj (8,192 -> 288) and w_out (8,192 -> 4,096) at
# decode; the reduced jamba's w_in (128 -> 512) and w_x_proj (256 -> 24,
# whose 24 outputs fall off the TMA path) at 17 and 128 rows
SSM_LINEARS = [(8, 2048, 2048), (8, 2048, 7168), (8, 7168, 2048), (2048, 2048, 2048),
               (2048, 2048, 7168), (2048, 7168, 2048), (8, 4096, 16384), (8, 8192, 288),
               (8, 8192, 4096), (128, 128, 512), (128, 256, 24), (17, 256, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,M", SSM_LINEARS)
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_ssm_linears_match_plain(B, K, M, dt):
    """Each SSM linear's forward kernels (the fused pair, ``row_quantize`` +
    ``int8_matmul_dequant``, ``tensor_quantize``) and input-gradient
    kernels (the fused dgrad, the transposed matmul) bit-equal to their
    plain versions, as the serve and train paths' shapes above."""
    test_cuda_kernels_match_plain(B, K, M, dt)
    test_cuda_dgrad_kernels_match_plain(B, M, K, dt)


# the multimodal and enc-dec paths' linears (K, M) at their rows:
# internvl2-76b's 8,192 x 8,192 (wq, wo, frontend_proj), 8,192 x 1,024 (wk,
# wv), 8,192 x 28,672 (w_up, w_gate) and 28,672 x 8,192 (w_down) at decode
# (8) and train (8 x 320) rows, frontend_proj at 8 x 256; seamless-m4t-large-
# v2's 1,024 x 1,024 (attention, cross attention, frontend_proj), 1,024 x
# 8,192 and 8,192 x 1,024 at decode (8), the encoder's 8 x 4,096 rows, the
# train encoder's 2 x 4,096 and the train decoder's 2 x 64
MM_LINEARS = [(8, 8192, 8192), (8, 8192, 1024), (8, 8192, 28672), (8, 28672, 8192),
              (2048, 8192, 8192), (2560, 8192, 28672), (2560, 28672, 8192), (8, 1024, 1024),
              (8, 1024, 8192), (8, 8192, 1024), (32768, 1024, 1024), (8192, 1024, 8192),
              (8192, 8192, 1024), (128, 1024, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,M", MM_LINEARS)
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_multimodal_linears_match_plain(B, K, M, dt):
    """Each multimodal and enc-dec linear's forward and input-gradient
    kernels bit-equal to their plain versions, as the SSM linears above."""
    test_cuda_kernels_match_plain(B, K, M, dt)
    test_cuda_dgrad_kernels_match_plain(B, M, K, dt)


@pytest.mark.cuda
def test_cuda_f32_weight_quantizes_as_plain():
    """seamless's frontend_proj reaches the quantizer as its f32 master: the
    kernel's codes and state of an f32 (1,024, 1,024) weight that is not
    bf16-valued equal its plain version's, twice, and the fused forward on
    them at the encoder's 8 x 4,096 rows."""
    dev = _card()
    rng = np.random.default_rng(1024)
    w = torch.from_numpy(rng.standard_normal((1024, 1024)).astype(np.float32) / 32).to(dev)
    assert not torch.equal(w, w.bfloat16().float())
    w_q, s_w = TOPS.tensor_quantize(w)
    rq, rs = TREF.tensor_quantize(w)
    assert torch.equal(w_q, rq) and torch.equal(s_w, rs)
    assert torch.equal(TOPS.tensor_quantize(w)[0], w_q)
    x = _activations(rng, 32768, 1024).to(dev)
    assert torch.equal(TOPS.fused_switchback_fwd(x, w_q, s_w),
                       TREF.fused_switchback_fwd(x, w_q, s_w))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("R,C", [(1280, 1280), (588, 1280), (5120, 1280), (1024, 4096),
                                 (37, 70)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_col_quantize_matches_plain(R, C, dt):
    """The CLIP weights' shapes (patch_embed's 588 rows included), a ragged
    one, an all-zero column and a column of half-way ties."""
    dev = _card()
    rng = np.random.default_rng(R * C)
    w = rng.standard_normal((R, C)).astype(np.float32) / R ** 0.5
    w[:, 0] = 0.0
    w[:16, 1] = (2 * np.arange(16) - 15) / 256.0
    w[16, 1] = 127.0 / 128.0
    w = torch.from_numpy(w).to(dev, torch.bfloat16).to(dt)
    q, s = TOPS.col_quantize(w)
    rq, rs = TREF.col_quantize(w)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert torch.equal(TOPS.col_quantize(w)[0], q)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("R,C", [(17, 1), (1000, 7), (1000, 588), (17, 2049), (300, 5120),
                                 (3, 16385), (8193, 70), (5120, 33), (1025, 1280)])
@pytest.mark.parametrize("offset", [0, 1, 4])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_int8_quantizers_match_plain_at_the_edges(R, C, offset, dt):
    """``row_quantize`` (a warp to eight warps a row, the 4-value granules
    at K = 588, the wide path past 16,384) and ``col_quantize`` (ragged
    bands, ten slabs a cluster, the wide path past 8,192 rows) from an
    aligned base, an odd offset and 4 values in: half-way ties in row and
    column 1, an all-zero row and column 2, a lone outlier in the last row;
    bit-equal to the plain versions, twice the same bits."""
    dev = _card()
    rng = np.random.default_rng(R + 7 * C + offset)
    x = (rng.standard_normal((R, C)) * np.exp(rng.uniform(-4, 4, (R, 1)))).astype(np.float32)
    if C >= 3:
        x[:, 1], x[0, 1], x[:, 2] = np.arange(R) % 8 - 3.5, 127.0, 0.0
    if R >= 3:
        x[1], x[1, 0], x[2] = np.arange(C) % 8 - 3.5, 127.0, 0.0
    x[-1, min(3, C - 1)] = 1000.0
    buf = torch.empty(R * C + offset, device=dev, dtype=dt)
    buf[offset:] = torch.from_numpy(x).to(dev).reshape(-1).to(dt)
    x = buf[offset:].view(R, C)
    for name in ("row_quantize", "col_quantize"):
        got, want = getattr(TOPS, name)(x), getattr(TREF, name)(x)
        again = getattr(TOPS, name)(x)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, w) and torch.equal(g, a), name
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,M", [(4128, 1280, 1280), (4128, 1280, 5120), (2464, 4096, 1024),
                                   (8, 588, 1280), (37, 130, 70)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_colscale_matmul_matches_plain(B, K, M, dt):
    """The rank-1 epilogue in both orientations, bit-equal to its plain
    version: the forward (w_q (K, M), W's column state) and the dgrad
    (w_q (M, K) row-quantized, its state transposed)."""
    dev = _card()
    rng = np.random.default_rng(B + K + M)
    x = _activations(rng, B, K).to(dev)
    w = torch.from_numpy(rng.standard_normal((K, M)).astype(np.float32)).to(dev, torch.bfloat16)
    x_q, s_x = TOPS.row_quantize(x)
    row = TREF.div(s_x, 16129.0)
    w_q, s_w = TOPS.col_quantize(w)
    assert torch.equal(TOPS.int8_matmul_dequant(x_q, w_q, row, col_scale=s_w, out_dtype=dt),
                       TREF.int8_matmul_dequant(x_q, w_q, row, col_scale=s_w, out_dtype=dt))
    w_n, s_n = TOPS.row_quantize(w.t().contiguous())                 # (M, K), (M, 1)
    col = s_n.reshape(1, -1)
    assert torch.equal(TOPS.int8_matmul_dequant_t(x_q, w_n, row, col_scale=col, out_dtype=dt),
                       TREF.int8_matmul_dequant_t(x_q, w_n, row, col_scale=col, out_dtype=dt))
    torch.cuda.synchronize()


def _int8_forms(x_q, s_x, w, dt):
    """The four forms of int8_matmul_dequant on x_q (B, K) and the bf16
    weight w (K, M), each as (name, kernel call, plain output): the row-scale
    forward on W (K, M) tensor-quantized, the colscale forward on W
    column-quantized, and the transposed (dgrad) forms on W^T (M, K)
    tensor- and row-quantized."""
    wt = w.t().contiguous()
    w_q, s_w = TOPS.tensor_quantize(w)
    w_c, s_c = TOPS.col_quantize(w)
    w_t, s_t = TOPS.tensor_quantize(wt)
    w_n, s_n = TOPS.row_quantize(wt)
    row, row_t, unit = (s_x * TREF.div(s_w, 16129.0), s_x * TREF.div(s_t, 16129.0),
                        TREF.div(s_x, 16129.0))
    col = s_n.reshape(1, -1)
    kw = dict(out_dtype=dt)
    return [
        ("int8_matmul_dequant", lambda: TOPS.int8_matmul_dequant(x_q, w_q, row, **kw),
         TREF.int8_matmul_dequant(x_q, w_q, row, **kw)),
        ("int8_matmul_dequant_colscale",
         lambda: TOPS.int8_matmul_dequant(x_q, w_c, unit, col_scale=s_c, **kw),
         TREF.int8_matmul_dequant(x_q, w_c, unit, col_scale=s_c, **kw)),
        ("int8_matmul_dequant_t", lambda: TOPS.int8_matmul_dequant_t(x_q, w_t, row_t, **kw),
         TREF.int8_matmul_dequant_t(x_q, w_t, row_t, **kw)),
        ("int8_matmul_dequant_colscale_t",
         lambda: TOPS.int8_matmul_dequant_t(x_q, w_n, unit, col_scale=col, **kw),
         TREF.int8_matmul_dequant_t(x_q, w_n, unit, col_scale=col, **kw))]


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,M", [(1, 2560, 960), (8, 2560, 960), (16, 960, 320),
                                   (17, 960, 320), (1000, 2560, 960), (2048, 960, 2560),
                                   (4128, 5120, 1280), (8192, 588, 1280), (8, 588, 1280),
                                   (37, 130, 70)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_int8_matmul_forms_bitwise(B, K, M, dt):
    """int8_matmul_dequant on int8 wgmma, all four forms bit-equal to their
    plain versions and twice the same bits: the swapped decode form (B <=
    16), a ragged M (320 against 128-wide tiles), the masked producer (x_q's
    pitch 588 or 130 bytes, M = 70), the paths' training and CLIP shapes."""
    dev = _card()
    rng = np.random.default_rng(7 * B + K + M)
    x_q, s_x = TOPS.row_quantize(_activations(rng, B, K).to(dev))
    w = torch.from_numpy(rng.standard_normal((K, M)).astype(np.float32)).to(dev, torch.bfloat16)
    for name, fn, want in _int8_forms(x_q, s_x, w, dt):
        got = fn()
        assert got.dtype == dt and got.shape == (B, M), name
        assert torch.equal(got, want), f"{name}: max |diff| {_maxdiff(got, want)}"
        assert torch.equal(fn(), got), f"{name}: two launches differ"
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 300])
def test_cuda_int8_matmul_widest_sum_bitwise(B):
    """All-±127 operands at K = 5,120, CLIP's widest contraction: the s32
    sums reach 127^2 * 5,120 (a row and a column of +127 meet there), and
    every form stays bit-equal."""
    dev = _card()
    rng = np.random.default_rng(B)
    K, M = 5120, 1280
    x_q = torch.from_numpy(rng.choice([-127, 127], (B, K)).astype(np.int8)).to(dev)
    x_q[0] = 127
    s_x = torch.from_numpy(rng.uniform(0.5, 2.0, (B, 1)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.choice([-1.0, 1.0], (K, M)).astype(np.float32)).to(dev)
    w[:, 0] = 1.0
    for name, fn, want in _int8_forms(x_q, s_x, w.bfloat16(), torch.float32):
        got = fn()
        assert torch.equal(got, want), f"{name}: max |diff| {_maxdiff(got, want)}"
    acc = TOPS.int8_matmul_dequant(x_q, TOPS.tensor_quantize(w)[0],
                                   torch.ones((B, 1), device=dev), out_dtype=torch.float32)
    assert float(acc[0, 0]) == 127.0 * 127.0 * K
    torch.cuda.synchronize()


def _maxdiff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


@pytest.mark.cuda
def test_cuda_tensors_launch_the_kernels():
    dev = _card()
    TOPS.reset_launch_counts()
    x = torch.randn(4, 64, device=dev, dtype=torch.bfloat16)
    w_q, s_w = TOPS.tensor_quantize(torch.randn(64, 32, device=dev))
    TOPS.fused_switchback_fwd(x, w_q, s_w)
    x_q, s_x = TOPS.row_quantize(x)
    TOPS.int8_matmul_dequant(x_q, w_q, s_x * TREF.div(s_w, 16129.0))
    g = torch.randn(4, 32, device=dev, dtype=torch.bfloat16)
    TOPS.fused_switchback_dgrad(g, w_q, s_w)
    TOPS.int8_matmul_dequant_t(x_q[:, :32].contiguous(), w_q, s_x)
    w_c, s_c = TOPS.col_quantize(torch.randn(64, 32, device=dev))
    TOPS.int8_matmul_dequant(x_q, w_c, s_x, col_scale=s_c)
    TOPS.int8_matmul_dequant_t(x_q[:, :32].contiguous(), w_q, s_x,
                               col_scale=s_x.reshape(1, -1)[:, :4].repeat(1, 16))
    TOPS.wgrad_bf16(x, g)
    torch.cuda.synchronize()
    counts = TOPS.launch_counts()
    assert counts == {k: 1 for k in counts}
    assert set(counts) == {"tensor_quantize", "fused_switchback_fwd", "row_quantize",
                           "col_quantize", "int8_matmul_dequant",
                           "int8_matmul_dequant_colscale", "fused_switchback_dgrad",
                           "int8_matmul_dequant_t", "int8_matmul_dequant_colscale_t",
                           "wgrad_bf16"}
    with pytest.raises(ValueError):                 # mixed devices
        TOPS.fused_switchback_fwd(x, w_q.cpu(), s_w)


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", FLASH_DTYPES, ids=["bf16", "f32", "f16"])
@pytest.mark.parametrize("B,Sq,Sk,kv_valid,causal", [
    (8, 32, 32, 32, True), (8, 128, 128, 128, True), (8, 96, 96, 96, False),
    (8, 64, 160, 150, False), (8, 64, 160, 150, True), (3, 37, 37, 37, True)])
def test_cuda_flash_fwd_matches_plain(B, Sq, Sk, kv_valid, causal, dt):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(B * Sq + Sk)
    q = torch.randn((B, Sq, 15, 64), generator=gen, device=dev).to(dt)
    k = torch.randn((B, Sk, 5, 64), generator=gen, device=dev).to(dt)
    v = torch.randn((B, Sk, 5, 64), generator=gen, device=dev).to(dt)
    o, lse = FA.flash_fwd_lse(q, k, v, causal=causal, kv_valid=kv_valid)
    ro, rlse = FREF.mha_fwd(q, k, v, causal=causal, kv_valid=kv_valid,
                            scale=FA.softmax_scale(64))
    torch.cuda.synchronize()
    assert o.dtype == dt and bool(torch.isfinite(o).all())
    assert _rel(o, ro) <= O_TOL[dt]
    assert float((lse - rlse).abs().max()) <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dt", FLASH_DTYPES, ids=["bf16", "f32", "f16"])
@pytest.mark.parametrize("B,Sq,Sk,kv_valid,H,KV,hd,causal", [
    (4, 129, 129, 129, 16, 16, 80, False), (4, 77, 77, 77, 16, 16, 64, True),
    (3, 37, 50, 45, 15, 5, 64, False), (3, 37, 50, 45, 16, 16, 80, True),
    (2, 200, 200, 130, 15, 5, 64, True), (2, 21, 21, 21, 4, 4, 80, True),
    (2, 100, 100, 100, 15, 5, 64, False)])
def test_cuda_flash_fwd_clip_and_ragged_shapes(B, Sq, Sk, kv_valid, H, KV, hd, causal, dt):
    """flash_fwd at CLIP's head dims, hd 64 and 80, causal and full,
    kv_valid < Sk, Sq off multiples of 16 and 64, GQA and not: within
    O_TOL / LSE_TOL, two launches the same bits."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(B * Sq + hd)
    q = torch.randn((B, Sq, H, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((B, Sk, KV, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((B, Sk, KV, hd), generator=gen, device=dev).to(dt)
    o, lse = FA.flash_fwd_lse(q, k, v, causal=causal, kv_valid=kv_valid)
    ro, rlse = FREF.mha_fwd(q, k, v, causal=causal, kv_valid=kv_valid,
                            scale=FA.softmax_scale(hd))
    o2, lse2 = FA.flash_fwd_lse(q, k, v, causal=causal, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert o.dtype == dt and bool(torch.isfinite(o).all())
    assert _rel(o, ro) <= O_TOL[dt]
    assert float((lse - rlse).abs().max()) <= LSE_TOL
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("S,H,KV,hd,cache", [
    (96, 15, 5, 64, "bf16"), (256, 15, 5, 64, "bf16"), (256, 15, 5, 64, "f32"),
    (100, 16, 2, 64, "bf16"), (200, 8, 1, 80, "f32"), (131, 12, 3, 128, "bf16"),
    (1500, 15, 5, 64, "bf16"), (96, 6, 2, 48, "f32"), (64, 4, 2, 36, "bf16"),
    (64, 64, 8, 128, "bf16"), (33, 16, 16, 64, "bf16"),
    (256, 24, 2, 128, "bf16"), (256, 16, 1, 128, "bf16"), (131, 17, 1, 128, "f32"),
    (256, 48, 1, 128, "bf16"), (1500, 48, 1, 128, "bf16"), (64, 128, 2, 128, "bf16"),
    (96, 64, 1, 128, "f32")])
def test_cuda_decode_matches_plain(S, H, KV, hd, cache, dt):
    """decode_fwd (split-key, ops.decode_split) within O_TOL of its plain
    version: q bf16 or f32 over a bf16 or f32 cache, groups 1 (seamless's
    decoder), 3, 4 and 8 (internvl2's, hd 128 over 8 KV heads), the wide
    groups in row tiles of 16 (12: starcoder2's 24 over 2; 16, one tile; 17,
    a second tile of one row; 48: granite's MQA, 3 tiles; 64, also over an
    f32 cache), hd
    36 and 48 (padded to 64; 36 staged by plain loads), 64, 80 and 128,
    S_max off the part (100, 131) and past 64 parts of 16 keys (1,500:
    32-key parts), slots at kv_len 0 (o = 0) to S_max; two launches the
    same bits."""
    dev = _card()
    lens = torch.tensor([1, 2, 127, 128, 129, 200, S, S // 2, 0], dtype=torch.int32,
                        device=dev).clamp(max=S)
    B = lens.numel()
    cdt = torch.bfloat16 if cache == "bf16" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(S + hd)
    q = torch.randn((B, 1, H, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(cdt)
    v = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(cdt)
    o = FA.decode_attention(q, k, v, lens)
    ro = FREF.decode_fwd(q, k, v, lens, scale=FA.softmax_scale(hd))
    o2 = FA.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert o.dtype == dt and bool(torch.isfinite(o).all())
    assert _rel(o, ro) <= O_TOL[dt]
    assert float(o[-1].abs().sum()) == 0.0                     # kv_len 0
    assert torch.equal(o, o2)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", FLASH_DTYPES, ids=["bf16", "f32", "f16"])
@pytest.mark.parametrize("B,S,kv_valid,causal", [
    (8, 256, 256, True), (8, 200, 200, False), (8, 64, 50, True), (8, 64, 50, False),
    (3, 37, 37, True)])
def test_cuda_flash_bwd_matches_plain(B, S, kv_valid, causal, dt):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(B * S + kv_valid)
    q = torch.randn((B, S, 15, 64), generator=gen, device=dev).to(dt)
    k = torch.randn((B, S, 5, 64), generator=gen, device=dev).to(dt)
    v = torch.randn((B, S, 5, 64), generator=gen, device=dev).to(dt)
    do = torch.randn((B, S, 15, 64), generator=gen, device=dev).to(dt)
    o, lse = FA.flash_fwd_lse(q, k, v, causal=causal, kv_valid=kv_valid)
    di = FREF.attention_di(o, do)
    kw = dict(causal=causal, kv_valid=kv_valid)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, di, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, di, **kw)
    scale = FA.softmax_scale(64)
    rdq = FREF.flash_bwd_dq(q, k, v, do, lse, di, scale=scale, **kw)
    rdk, rdv = FREF.flash_bwd_dkv(q, k, v, do, lse, di, scale=scale, **kw)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        assert _rel(got, want) <= BWD_TOL[dt]
    assert float(dk[:, kv_valid:].abs().sum()) == 0.0 == float(dv[:, kv_valid:].abs().sum())
    assert torch.equal(FA.flash_bwd_dq(q, k, v, do, lse, di, **kw), dq)     # rerun
    assert all(torch.equal(a, b) for a, b in zip(FA.flash_bwd_dkv(q, k, v, do, lse, di, **kw),
                                                 (dk, dv)))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", FLASH_DTYPES, ids=["bf16", "f32", "f16"])
@pytest.mark.parametrize("B,S,H,KV,hd,kv_valid,causal", [
    (2, 70, 6, 2, 36, 70, True), (2, 70, 6, 2, 48, 60, False), (3, 50, 4, 4, 100, 50, True),
    (2, 21, 16, 16, 80, 21, False)])
def test_cuda_flash_bwd_dq_head_dims(B, S, H, KV, hd, kv_valid, causal, dt):
    """flash_bwd_dq at head dims padded in shared memory (36 and 48 to 64,
    36 staged by plain loads; 100 to 128) and with fewer rows than one
    tile of four warps: within BWD_TOL of its plain version, two launches
    the same bits."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(B * S + hd)
    q, do = (torch.randn((B, S, H, hd), generator=gen, device=dev).to(dt) for _ in range(2))
    k, v = (torch.randn((B, S, KV, hd), generator=gen, device=dev).to(dt) for _ in range(2))
    kw = dict(causal=causal, kv_valid=kv_valid)
    o, lse = FA.flash_fwd_lse(q, k, v, **kw)
    di = FREF.attention_di(o, do)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, di, **kw)
    rdq = FREF.flash_bwd_dq(q, k, v, do, lse, di, scale=FA.softmax_scale(hd), **kw)
    torch.cuda.synchronize()
    assert dq.dtype == torch.float32 and bool(torch.isfinite(dq).all())
    assert _rel(dq, rdq) <= BWD_TOL[dt]
    assert torch.equal(FA.flash_bwd_dq(q, k, v, do, lse, di, **kw), dq)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", FLASH_DTYPES, ids=["bf16", "f32", "f16"])
@pytest.mark.parametrize("B,S,H,KV,hd,causal", [
    (8, 256, 15, 5, 64, True), (32, 129, 16, 16, 80, False), (32, 77, 16, 16, 64, True)],
    ids=["smollm", "clip_vision", "clip_text"])
def test_cuda_flash_tensor_core_kernels_at_path_shapes(B, S, H, KV, hd, causal, dt):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv (mma.sync, the tile step
    of kernels/csrc/mma_tile.cuh) at the training paths' full attention
    shapes: within O_TOL / LSE_TOL and BWD_TOL of their plain versions,
    two launches the same bits."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(B * S + hd)
    q, do = (torch.randn((B, S, H, hd), generator=gen, device=dev).to(dt) for _ in range(2))
    k, v = (torch.randn((B, S, KV, hd), generator=gen, device=dev).to(dt) for _ in range(2))
    scale = FA.softmax_scale(hd)
    o, lse = FA.flash_fwd_lse(q, k, v, causal=causal)
    ro, rlse = FREF.mha_fwd(q, k, v, causal=causal, kv_valid=S, scale=scale)
    assert _rel(o, ro) <= O_TOL[dt] and float((lse - rlse).abs().max()) <= LSE_TOL
    o2, lse2 = FA.flash_fwd_lse(q, k, v, causal=causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    di = FREF.attention_di(o, do)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, di, causal=causal)
    rdq = FREF.flash_bwd_dq(q, k, v, do, lse, di, causal=causal, kv_valid=S, scale=scale)
    assert dq.dtype == torch.float32 and _rel(dq, rdq) <= BWD_TOL[dt]
    assert torch.equal(FA.flash_bwd_dq(q, k, v, do, lse, di, causal=causal), dq)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, di, causal=causal)
    rdk, rdv = FREF.flash_bwd_dkv(q, k, v, do, lse, di, causal=causal, kv_valid=S, scale=scale)
    assert _rel(dk, rdk) <= BWD_TOL[dt] and _rel(dv, rdv) <= BWD_TOL[dt]
    assert all(torch.equal(a, b) for a, b in zip(FA.flash_bwd_dkv(q, k, v, do, lse, di,
                                                                  causal=causal), (dk, dv)))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", [
    (1, 4096, 4096, 16, 16, 64, False), (2, 64, 4096, 16, 16, 64, False),
    (8, 1, 4096, 16, 16, 64, False), (8, 320, 320, 64, 8, 128, True),
    (4, 16, 32, 4, 4, 32, False)],
    ids=["seamless_encoder", "seamless_cross_train", "seamless_cross_decode", "internvl2",
         "seamless_reduced_cross"])
def test_cuda_flash_kernels_at_multimodal_shapes(B, Sq, Sk, H, KV, hd, causal, dt):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv at the multimodal and
    enc-dec paths' attention shapes, cross attention's Sq != Sk included:
    within O_TOL / LSE_TOL and BWD_TOL of their plain versions, two launches
    the same bits."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(B * Sq + Sk + hd)
    q, do = (torch.randn((B, Sq, H, hd), generator=gen, device=dev).to(dt) for _ in range(2))
    k, v = (torch.randn((B, Sk, KV, hd), generator=gen, device=dev).to(dt) for _ in range(2))
    scale = FA.softmax_scale(hd)
    kw = dict(causal=causal, kv_valid=Sk)
    o, lse = FA.flash_fwd_lse(q, k, v, **kw)
    ro, rlse = FREF.mha_fwd(q, k, v, scale=scale, **kw)
    assert _rel(o, ro) <= O_TOL[dt] and float((lse - rlse).abs().max()) <= LSE_TOL
    assert all(torch.equal(a, b) for a, b in zip(FA.flash_fwd_lse(q, k, v, **kw), (o, lse)))
    di = FREF.attention_di(o, do)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, di, **kw)
    rdq = FREF.flash_bwd_dq(q, k, v, do, lse, di, scale=scale, **kw)
    assert dq.dtype == torch.float32 and _rel(dq, rdq) <= BWD_TOL[dt]
    assert torch.equal(FA.flash_bwd_dq(q, k, v, do, lse, di, **kw), dq)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, di, **kw)
    rdk, rdv = FREF.flash_bwd_dkv(q, k, v, do, lse, di, scale=scale, **kw)
    assert _rel(dk, rdk) <= BWD_TOL[dt] and _rel(dv, rdv) <= BWD_TOL[dt]
    assert all(torch.equal(a, b) for a, b in zip(FA.flash_bwd_dkv(q, k, v, do, lse, di, **kw),
                                                 (dk, dv)))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_tensors_launch_the_flash_kernels():
    dev = _card()
    FA.reset_launch_counts()
    q = torch.randn(2, 8, 6, 64, device=dev, dtype=torch.bfloat16)
    k = torch.randn(2, 8, 2, 64, device=dev, dtype=torch.bfloat16)
    FA.flash_fwd_lse(q, k, k, causal=True)
    FA.decode_attention(q[:, :1].contiguous(), k, k,
                        torch.tensor([3, 8], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    o, lse = FA.flash_fwd_lse(q, k, k, causal=True)
    di = FREF.attention_di(o, q)
    FA.flash_bwd_dq(q, k, k, q, lse, di, causal=True)
    FA.flash_bwd_dkv(q, k, k, q, lse, di, causal=True)
    torch.cuda.synchronize()
    assert FA.launch_counts() == {"flash_fwd": 2, "decode_fwd": 1, "flash_bwd_dq": 1,
                                  "flash_bwd_dkv": 1}
    with pytest.raises(ValueError):                 # mixed devices
        FA.decode_attention(q[:, :1].contiguous(), k, k, torch.tensor([3, 8], dtype=torch.int32))


# ---------------------------------------------------------------------------
# the fp8 kernels
# ---------------------------------------------------------------------------

def _bits(t):
    return t.view(torch.uint8) if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2) else t


def _fp8_activations(gen, R, C, dev, outliers=False):
    x = torch.randn((R, C), generator=gen, device=dev) * 3
    x[min(2, R - 1)] = 0.0
    if outliers:
        x[:128, :128] *= 40.0
        x[-1, -1] = 500.0
    return x


def _within_bound(got, want, bnd) -> float:
    """The largest |got - want| as a share of matmul_bound (at most 1)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    return float(((got.double() - want.double()).abs() / bnd).max())


def _quantizer_input(gen, R, C, dev, dt, offset=0):
    """``_fp8_activations`` at scales e^-4..e^4 a row, with the cases the
    quantizers' arithmetic must keep: exact fp8 ties at absmax 1 (k/64 for
    |k| <= 64: midpoints of both grids in [1/4, 1)), an all-zero row, ±0
    beside 1.0, bf16 subnormals alone (the 1e-12 floor) and beside 1.0, an
    all-zero 128 x 128 tile. ``offset``: the elements the contiguous view
    starts after its buffer's start (an odd one: not 16-byte aligned)."""
    x = _fp8_activations(gen, R, C, dev)
    x = x * torch.exp(torch.empty((R, 1), device=dev).uniform_(-4, 4, generator=gen))
    k = torch.arange(C, device=dev)
    tiny = ((k % 7) - 3).float() * 2.0 ** -133
    rows = {1: ((k % 129) - 64).float() / 64, 2: torch.zeros(C, device=dev),
            3: torch.where(k % 2 == 0, -0.0, 0.0), 4: tiny, 5: tiny}
    for r, v in rows.items():
        if r < R:
            x[r] = v
            if r in (3, 5):
                x[r, 0] = 1.0
    if R > 256 and C > 128:
        x[128:256, :128] = 0.0
    x = x.to(dt)
    if offset:
        buf = torch.empty(R * C + offset, dtype=dt, device=dev)
        buf[offset:] = x.reshape(-1)
        x = buf[offset:].view(R, C)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("R,C", [(4128, 1280), (1032, 5120), (8192, 588), (37, 130),
                                 (2464, 1024), (2464, 4096), (4128, 5120), (300, 2048),
                                 (300, 2049)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_fp8_quantizers_match_plain(R, C, fmt, dt):
    """The three quantizers bit-equal to their plain versions (q's bytes and
    the state) at the paths' shapes and the warp-per-row path's K edges, on
    ``_quantizer_input``'s cases, from an aligned base and an odd offset;
    each launched twice gives the same bits."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(R + C)
    for offset in (0, 1):
        x = _quantizer_input(gen, R, C, dev, dt, offset)
        for name, args in (("row_quantize", ()), ("tensor_quantize", ()),
                           ("block_quantize", (128, 128)), ("block_quantize", (64, 32)),
                           ("block_quantize", (64, 64))):
            got = getattr(F8, name)(x, fmt, *args)
            again = getattr(F8, name)(x, fmt, *args)
            want = getattr(F8REF, name)(x, fmt, *args)
            for g, a, w in zip(got, again, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert torch.equal(_bits(g), _bits(w)), (name, args, offset)
                assert torch.equal(_bits(g), _bits(a)), (name, args, offset)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_cuda_fp8_conversion_is_grid_round_on_every_f32(fmt):
    """The quantizers' byte conversion (NaN to -max, then the card's
    round-to-nearest-even conversion) equals encode(grid_round(y)) on every
    f32 bit pattern y."""
    _card()
    assert F8.encode_check(fmt) == 0


@pytest.mark.cuda
def test_cuda_fp8_bf16_division_is_ieee_on_every_pair():
    """The bf16 quantizers' division (a reciprocal once a tile, an fma
    correction) gives __fdiv_rn's bits on every bf16 x and every absmax a
    bf16 row or tile can have."""
    _card()
    assert F8.divide_check() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,M", [(4128, 1280, 1280), (1032, 1280, 5120), (1032, 5120, 1280),
                                   (2464, 1024, 4096), (8192, 588, 1280), (37, 130, 70)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_fp8_matmuls_match_plain(B, K, M, dt):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(B + K + M)
    w = (torch.randn((K, M), generator=gen, device=dev) / K ** 0.5).to(torch.bfloat16)
    w_q, s_w = F8.tensor_quantize(w, "e4m3")
    x = _fp8_activations(gen, B, K, dev, outliers=True).to(dt)
    x_q, s_x = F8.row_quantize(x, "e4m3")
    rows = torch.tensor(F8TC.check_rows(B), device=dev)
    y = F8.fp8_matmul_dequant(x_q, w_q, s_x * s_w, out_dtype=dt)
    want = F8REF.fp8_matmul_dequant(x_q, w_q, s_x * s_w, out_dtype=dt)
    assert _within_bound(y, want, F8REF.matmul_bound(want, x_q, w_q, s_x * s_w)) <= 1.0
    assert torch.equal(y[rows], F8TC.dequant_rows(x_q, w_q, s_x * s_w, rows, out_dtype=dt))
    assert torch.equal(y, F8.fp8_matmul_dequant(x_q, w_q, s_x * s_w, out_dtype=dt))
    g = _fp8_activations(gen, B, M, dev, outliers=True).to(dt)
    g_q, s_g = F8.row_quantize(g, "e5m2")
    y = F8.fp8_matmul_dequant_t(g_q, w_q, s_g * s_w, out_dtype=dt)
    want = F8REF.fp8_matmul_dequant(g_q, w_q, s_g * s_w, transpose_w=True, out_dtype=dt)
    bnd = F8REF.matmul_bound(want, g_q, w_q, s_g * s_w, transpose_w=True)
    assert _within_bound(y, want, bnd) <= 1.0
    assert torch.equal(y[rows], F8TC.dequant_rows(g_q, w_q, s_g * s_w, rows, transpose_w=True,
                                                  out_dtype=dt))
    assert torch.equal(y, F8.fp8_matmul_dequant_t(g_q, w_q, s_g * s_w, out_dtype=dt))
    for a, fmt, tw in ((x, "e4m3", False), (g, "e5m2", True)):
        a_q, s_blk = F8.block_quantize(a, fmt)
        fb = F8.fallback_mask(s_blk, 8.0)
        assert B < 1024 or 0 < float(fb.sum()) < fb.numel()      # both branches run
        fn = F8.fp8_mixed_matmul_t if tw else F8.fp8_mixed_matmul
        got = fn(a, a_q, s_blk, fb, w_q, s_w, out_dtype=dt)
        kw = dict(block_rows=128, block_cols=128, transpose_w=tw)
        want = F8REF.fp8_mixed_matmul(a, a_q, s_blk, fb, w_q, s_w, out_dtype=dt, **kw)
        bnd = F8REF.matmul_bound(want, a_q, w_q, x16=a, s_blk=s_blk, fb_blk=fb, s_w=s_w, **kw)
        assert _within_bound(got, want, bnd) <= 1.0, tw
        assert torch.equal(got[rows], F8TC.mixed_rows(a, a_q, s_blk, fb, w_q, s_w, rows,
                                                      out_dtype=dt, **kw)), tw
        assert torch.equal(got, fn(a, a_q, s_blk, fb, w_q, s_w, out_dtype=dt))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,M", [(4128, 1280, 1280), (1032, 5120, 1280), (2464, 1024, 4096),
                                   (8192, 588, 1280), (37, 130, 70), (300, 640, 384)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("tiles", [(128, 128), (16, 32), (64, 48)], ids=["128x128", "16x32",
                                                                          "64x48"])
def test_cuda_fp8_matmuls_exact_entries_bitwise(B, K, M, dt, tiles):
    """On entries whose window sums are exact at the tensor cores' width,
    all four forms give their plain versions' bits: ragged shapes, the
    masked load path (K = 588, 130), scale tiles under a window and off
    its 32-column steps (16 x 32, 64 x 48), a checkerboard of fallback
    tiles, E4M3 forward and E5M2 input gradient."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3 * B + K)
    br, bc = tiles
    w_q, s_w = F8.tensor_quantize(F8REF.exact_entries((K, M), gen, dev) * 0.125, "e4m3")
    for shape, fmt, tw in (((B, K), "e4m3", False), ((B, M), "e5m2", True)):
        a = F8REF.exact_entries(shape, gen, dev).to(dt)
        a_q, s_a = F8.row_quantize(a, fmt)
        fn = F8.fp8_matmul_dequant_t if tw else F8.fp8_matmul_dequant
        assert torch.equal(fn(a_q, w_q, s_a * s_w, out_dtype=dt),
                           F8REF.fp8_matmul_dequant(a_q, w_q, s_a * s_w, transpose_w=tw,
                                                    out_dtype=dt)), tw
        b_q, s_blk = F8.block_quantize(a, fmt, br, bc)
        i = torch.arange(s_blk.shape[0], device=dev)[:, None]
        j = torch.arange(s_blk.shape[1], device=dev)[None, :]
        fb = ((i + j) % 2 == 1).float()
        fn = F8.fp8_mixed_matmul_t if tw else F8.fp8_mixed_matmul
        got = fn(a, b_q, s_blk, fb, w_q, s_w, block_rows=br, block_cols=bc, out_dtype=dt)
        want = F8REF.fp8_mixed_matmul(a, b_q, s_blk, fb, w_q, s_w, block_rows=br, block_cols=bc,
                                      transpose_w=tw, out_dtype=dt)
        assert torch.equal(got, want), (tw, float((got.float() - want.float()).abs().max()))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_tensors_launch_the_fp8_kernels():
    dev = _card()
    F8.reset_launch_counts()
    x = torch.randn(64, 256, device=dev, dtype=torch.bfloat16)
    w_q, s_w = F8.tensor_quantize(torch.randn(256, 96, device=dev), "e4m3")
    x_q, s_x = F8.row_quantize(x, "e4m3")
    F8.fp8_matmul_dequant(x_q, w_q, s_x * s_w)
    F8.fp8_matmul_dequant_t(F8.row_quantize(torch.randn(64, 96, device=dev), "e5m2")[0],
                            w_q, s_x * s_w)
    F8.mixed(x, w_q, s_w)
    F8.mixed(torch.randn(64, 96, device=dev), w_q, s_w, fmt="e5m2", transpose_w=True)
    torch.cuda.synchronize()
    assert F8.launch_counts() == {
        "fp8_row_quantize": 2, "fp8_tensor_quantize": 1, "fp8_block_quantize": 2,
        "fp8_matmul_dequant": 1, "fp8_matmul_dequant_t": 1, "fp8_mixed_matmul": 1,
        "fp8_mixed_matmul_t": 1, "fp8_transpose_bytes": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("K,M", [(1280, 3840), (5120, 1280), (588, 1280), (130, 70), (37, 5)])
def test_cuda_transpose_bytes_matches_plain(K, M):
    """The forward's K-major copy of W, byte for byte, at CLIP's weight
    shapes and ragged ones (rows and columns off the 4-byte words)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(K + M)
    w_q, _ = F8.tensor_quantize(torch.randn((K, M), generator=gen, device=dev), "e4m3")
    F8.reset_launch_counts()
    got = F8.transpose_bytes(w_q)
    assert F8.launch_counts()["fp8_transpose_bytes"] == 1
    assert got.dtype == torch.uint8 and torch.equal(got, w_q.view(torch.uint8).t().contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("K,M", [(1280, 3840), (5120, 1280), (588, 1280), (130, 70), (37, 5)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_tensor_quantize_kt_is_tensor_quantize_and_transpose_bytes(K, M, dt):
    """The fold, both formats: q and the state bit-equal to
    ``tensor_quantize``'s, q_k to ``transpose_bytes`` of that q, twice the
    same bits, one CUDA kernel a call (two past the registers, as f32 at
    1,280 x 3,840 and 5,120 x 1,280; counted once as fp8_tensor_quantize); the
    forwards given its q_k bit-equal to the same calls through
    ``transpose_bytes``."""
    from torch.profiler import ProfilerActivity, profile
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(K * M)
    w = (torch.randn((K, M), generator=gen, device=dev)
         * torch.exp(torch.empty((K, M), device=dev).uniform_(-4, 4, generator=gen))).to(dt)
    for fmt in ("e4m3", "e5m2"):
        F8.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            q, s, q_k = F8.tensor_quantize_kt(w, fmt)
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages() if "tensor_quantize" in e.key)
        passes = 1 if F8.tensor_quantize_kt_plan(w)["rounds"] == 0 else 2   # f32 past ~4.3 M
        assert kernels <= passes and F8.launch_counts()["fp8_tensor_quantize"] == 1, kernels
        rq, rs = F8.tensor_quantize(w, fmt)
        assert torch.equal(_bits(q), _bits(rq)) and torch.equal(s, rs)
        assert torch.equal(_bits(q), _bits(F8REF.tensor_quantize(w, fmt)[0]))
        assert q_k.dtype == torch.uint8 and torch.equal(q_k, F8.transpose_bytes(rq))
        again = F8.tensor_quantize_kt(w, fmt)
        assert torch.equal(_bits(again[0]), _bits(q)) and torch.equal(again[2], q_k)
    w_q, s_w, w_k = F8.tensor_quantize_kt(w, "e4m3")
    x = (torch.randn((300, K), generator=gen, device=dev) * 3).to(dt)
    x[:, :4] *= 1000.0                                 # tiles that fall back in fp8_mixed
    x_q, s_x = F8.row_quantize(x, "e4m3")
    for kw in ({}, {"out_dtype": torch.float32}):
        assert torch.equal(F8.fp8_matmul_dequant(x_q, w_q, s_x * s_w, w_k=w_k, **kw),
                           F8.fp8_matmul_dequant(x_q, w_q, s_x * s_w, **kw))
        assert torch.equal(F8.mixed(x, w_q, s_w, block_rows=64, block_cols=64, w_k=w_k, **kw),
                           F8.mixed(x, w_q, s_w, block_rows=64, block_cols=64, **kw))


@pytest.mark.cuda
def test_cuda_tensor_quantize_kt_faults_are_caught():
    """The fold's control faults: block 0's partial left out changes the
    state where it holds the absmax; block 0's K-major tile left unwritten
    leaves 0xff bytes there."""
    dev = _card()
    w = torch.randn((1280, 1280), device=dev).to(torch.bfloat16)
    w[0, 0] = 100.0
    q, s, q_k = F8.tensor_quantize_kt(w, "e4m3")
    _, s_f, _ = F8.tensor_quantize_kt_fault(w, "e4m3", drop=0)
    assert float(s_f) < float(s)
    q_f, s_f, k_f = F8.tensor_quantize_kt_fault(w, "e4m3", skip=0)
    assert torch.equal(_bits(q_f), _bits(q)) and torch.equal(s_f, s)
    assert not torch.equal(k_f, q_k) and int(k_f[0, 0]) == 0xFF


# ---------------------------------------------------------------------------
# the paged-attention kernels
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_row_sum_and_rms_norm_are_row_count_invariant():
    """A row's sum of squares and its RMSNorm are the same bits whether it
    rides in a decode step (8 rows), a verify pass (40) or a prefill (up to
    8 x 4,096): what keeps spec-on and preempted tokens equal to plain
    decode's on the card."""
    from repro_torch.models.common import rms_norm, row_sum
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    base = torch.randn((8, 960), generator=gen, device=dev) * 3
    gain = torch.randn(960, generator=gen, device=dev)
    want_s, want_n = row_sum(base * base), rms_norm(base.bfloat16(), gain)
    for R in (1, 5, 40, 256, 2048, 4096):
        x = torch.randn((8, R, 960), generator=gen, device=dev) * 3
        x[:, R // 2] = base
        assert torch.equal(row_sum(x * x)[:, R // 2], want_s), R
        assert torch.equal(rms_norm(x.bfloat16(), gain)[:, R // 2], want_n), R


def _paged_inputs(dev, dt, B, nb, bs=16, seed=0, KV=5, hd=64):
    """Pools of B * nb blocks (+ the trash block) at smollm-360m's heads (or
    KV heads of hd), tables a permutation of them; the plain versions clamp
    dead ids, the kernels never read them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    N = B * nb
    k = torch.randn((N + 1, bs, KV, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((N + 1, bs, KV, hd), generator=gen, device=dev).to(dt)
    perm = torch.randperm(N, generator=gen, device=dev).to(torch.int32)
    return gen, k, v, perm.reshape(B, nb)


def _kill_dead(tables, kv_len, bs):
    """Table entries past each slot's live blocks -> an id outside the pool."""
    live = torch.div(kv_len + bs - 1, bs, rounding_mode="floor")
    j = torch.arange(tables.shape[1], device=tables.device)[None, :]
    return torch.where(j < live[:, None], tables, 10 ** 6).contiguous()


# (H, KV, hd) of the paged cases: smollm-360m's heads, and the wide query
# groups (12: starcoder2's 24 over 2; 16; 17; 48: granite's MQA; 64) at hd 128
PAGED_HEADS = [(15, 5, 64), (24, 2, 128), (16, 1, 128), (17, 1, 128), (48, 1, 128),
               (64, 1, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("H,KV,hd", PAGED_HEADS)
def test_cuda_paged_decode_matches_plain(H, KV, hd, dt):
    dev = _card()
    gen, k, v, tables = _paged_inputs(dev, torch.bfloat16, 8, 64, KV=KV, hd=hd)
    kv_len = torch.tensor([0, 1, 15, 16, 17, 300, 1000, 1024], dtype=torch.int32, device=dev)
    tables = _kill_dead(tables, kv_len, 16)
    q = torch.randn((8, 1, H, hd), generator=gen, device=dev).to(dt)
    o = PA.paged_decode_attention(q, k, v, tables, kv_len)
    ro = PREF.paged_decode_fwd(q, k, v, tables, kv_len, scale=FA.softmax_scale(hd))
    torch.cuda.synchronize()
    assert o.dtype == dt and bool(torch.isfinite(o).all()) and _rel(o, ro) <= O_TOL[dt]
    assert float(o[0].abs().max()) == 0.0                  # kv_len 0: exact zeros
    assert torch.equal(PA.paged_decode_attention(q, k, v, tables, kv_len), o)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("Sq", [1, 5, 128, 300])
@pytest.mark.parametrize("H,KV,hd", PAGED_HEADS)
def test_cuda_paged_prefill_matches_plain_and_decode(H, KV, hd, Sq, dt):
    """Ragged offsets off block edges and a dry slot; then every row
    bit-equal to the decode kernel at kv_len = its position + 1."""
    dev = _card()
    gen, k, v, tables = _paged_inputs(dev, torch.bfloat16, 8, 64, seed=Sq, KV=KV, hd=hd)
    q_off = torch.tensor([0, 3, 16, 100, 257, 500, 700, 0], dtype=torch.int32, device=dev)
    kv_len = (q_off + Sq).clamp(max=1024).to(torch.int32)
    kv_len[7] = 0                                          # not admitted: dry
    tables = _kill_dead(tables, kv_len, 16)
    q = torch.randn((8, Sq, H, hd), generator=gen, device=dev).to(dt)
    o = PA.paged_prefill_attention(q, k, v, tables, q_off, kv_len)
    ro = PREF.paged_prefill_fwd(q, k, v, tables, q_off, kv_len, scale=FA.softmax_scale(hd))
    torch.cuda.synchronize()
    live = kv_len > 0
    assert o.dtype == dt and bool(torch.isfinite(o).all())
    assert _rel(o[live], ro[live]) <= O_TOL[dt]
    assert float(o[7].abs().max()) == 0.0
    assert torch.equal(PA.paged_prefill_attention(q, k, v, tables, q_off, kv_len), o)
    for r in range(0, Sq, 1 if Sq in (5, 128) else max(1, Sq // 7)):
        lens = torch.where(live, (q_off + r + 1).clamp(max=1024), 0).to(torch.int32)
        rows = (q_off + r < kv_len) & live
        d = PA.paged_decode_attention(q[:, r:r + 1].contiguous(), k, v, tables, lens)
        assert torch.equal(d[rows], o[:, r:r + 1][rows]), r


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("group,KV", [(12, 2), (48, 1), (64, 1)])
def test_cuda_wide_group_equals_narrow(group, KV, dt):
    """A query head's output does not depend on the group it is launched
    in: decode_fwd and the paged decode at a wide group (and the paged
    prefill at S = 3) give, head for head, the bits of launches of groups
    of 8 (ring) and 16 (paged) over the same KV head's cache."""
    dev = _card()
    B, S, hd = 8, 200, 128
    gen = torch.Generator(device=dev).manual_seed(group * 7 + KV)
    lens = torch.tensor([1, 16, 17, 64, 100, 150, 200, 0], dtype=torch.int32, device=dev)
    H = group * KV
    q = torch.randn((B, 1, H, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(torch.bfloat16)
    wide = FA.decode_attention(q, k, v, lens)
    for h in range(KV):
        for g0 in range(0, group, 8):
            n = min(8, group - g0)
            heads = slice(h * group + g0, h * group + g0 + n)
            narrow = FA.decode_attention(q[:, :, heads].contiguous(), k[:, :, h:h + 1].contiguous(),
                                         v[:, :, h:h + 1].contiguous(), lens)
            assert torch.equal(narrow, wide[:, :, heads]), (h, g0)
    _, kp, vp, tables = _paged_inputs(dev, torch.bfloat16, B, 16, KV=KV, hd=hd, seed=group)
    q3 = torch.randn((B, 3, H, hd), generator=gen, device=dev).to(dt)
    q_off = (lens - 3).clamp(min=0)
    pw = PA.paged_decode_attention(q, kp, vp, tables, lens)
    fw = PA.paged_prefill_attention(q3, kp, vp, tables, q_off, lens)
    for h in range(KV):
        for g0 in range(0, group, 16):
            n = min(16, group - g0)
            heads = slice(h * group + g0, h * group + g0 + n)
            kh, vh = kp[:, :, h:h + 1].contiguous(), vp[:, :, h:h + 1].contiguous()
            assert torch.equal(PA.paged_decode_attention(q[:, :, heads].contiguous(), kh, vh,
                                                         tables, lens), pw[:, :, heads])
            assert torch.equal(PA.paged_prefill_attention(q3[:, :, heads].contiguous(), kh, vh,
                                                          tables, q_off, lens),
                               fw[:, :, heads])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_tensors_launch_the_paged_kernels():
    dev = _card()
    PA.reset_launch_counts()
    gen, k, v, tables = _paged_inputs(dev, torch.bfloat16, 2, 4, bs=4)
    q = torch.randn((2, 3, 6, 64), generator=gen, device=dev, dtype=torch.bfloat16)
    lens = torch.tensor([3, 9], dtype=torch.int32, device=dev)
    PA.paged_prefill_attention(q, k[:, :, :2].contiguous(), v[:, :, :2].contiguous(),
                               tables, lens - 3, lens)
    PA.paged_decode_attention(q[:, :1].contiguous(), k[:, :, :2].contiguous(),
                              v[:, :, :2].contiguous(), tables, lens)
    torch.cuda.synchronize()
    assert PA.launch_counts() == {"paged_decode_fwd": 1, "paged_prefill_fwd": 1}
    with pytest.raises(ValueError, match="devices"):   # mixed devices
        PA.paged_decode_attention(q[:, :1].contiguous(), k[:, :, :2].contiguous(),
                                  v[:, :, :2].contiguous(), tables, lens.cpu())


# ---------------------------------------------------------------------------
# the op-entry-point kernels: fp8_cast_tensorwise and wgrad_bf16
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("R,C", [(17, 130), (1030, 130), (4128, 1280)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_fp8_cast_matches_plain(R, C, fmt, dt):
    """Bit for bit, twice; the tensor's absmax (ties after scaling at
    absmax 64), a stale one, one that clips, and x one row in (a pointer
    off 16-byte alignment: the element-wise path)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(R + C)
    x = (torch.randn((R + 1, C), generator=gen, device=dev) * 8).clamp(-63, 63)
    unit = torch.from_numpy(fp8_values(SPECS[fmt])).float()
    unit = unit[unit <= 1.0]
    ties = ((unit[:-1] + unit[1:]) / 2 * 64)[:C - 1]          # exact ties at absmax 64
    x[0, 0] = x[1, 0] = 64.0
    x[1, 1:1 + len(ties)] = x[2, 1:1 + len(ties)] = ties.to(dev)
    x = x.to(dt)
    for xs in (x, x[1:]):
        am = xs.float().abs().amax()
        for absmax in (am, am * 3.7, am * 2.0 ** -17):
            got = FC.fp8_cast_tensorwise(xs, absmax, fmt)
            assert torch.equal(got.view(torch.int32),
                               FCREF.fp8_cast_tensorwise(xs, absmax, fmt).view(torch.int32))
            assert torch.equal(got.view(torch.int32),
                               FC.fp8_cast_tensorwise(xs, absmax, fmt).view(torch.int32))
    zero = torch.zeros((33, C), device=dev, dtype=dt)
    assert not bool(FC.fp8_cast_tensorwise(zero, torch.zeros((), device=dev), fmt).any())
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,M", [(8, 960, 320), (37, 130, 70), (1000, 588, 1280),
                                   (2048, 960, 2560), (8192, 588, 1280)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_wgrad_bf16_matches_plain(B, K, M, dt):
    """Within ref.wgrad_bound of the plain in-order sum, bit for bit on
    exact entries and to the tensor-core model at the check rows, twice the
    same bits, and within B · 2^-23 · (|x|ᵀ|g|) of cuBLAS; g's rows shifted
    by one (the control fault) outside both bounds. 588 columns take the
    masked (non-TMA) load path, 8 and 37 rows a ragged last window."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(B + K + M)
    x = torch.randn((B, K), generator=gen, device=dev).to(dt)
    g = torch.randn((B, M), generator=gen, device=dev).to(dt)
    got = TOPS.wgrad_bf16(x, g)
    plain = TREF.wgrad_bf16(x, g)
    wb = TREF.wgrad_bound(plain, x, g)
    assert bool(((got.double() - plain.double()).abs() <= wb).all())
    assert torch.equal(got.view(torch.int32), TOPS.wgrad_bf16(x, g).view(torch.int32))
    rows = F8TC.check_rows(K)
    assert torch.equal(got[rows].view(torch.int32), F8TC.wgrad_rows(x, g, rows).view(torch.int32))
    xe, ge = F8REF.exact_entries((B, K), gen, dev), F8REF.exact_entries((B, M), gen, dev)
    assert torch.equal(TOPS.wgrad_bf16(xe, ge).view(torch.int32),
                       TREF.wgrad_bf16(xe, ge).view(torch.int32))
    shifted = TOPS.wgrad_bf16(x, g.roll(1, dims=0)).double()
    assert not bool(((shifted - plain.double()).abs() <= wb).all())
    xb, gb = x.to(torch.bfloat16).double(), g.to(torch.bfloat16).double()
    bound = B * 2.0 ** -23 * (xb.abs().t() @ gb.abs())
    assert bool(((got.double() - SB.wgrad_16bit(x, g).double()).abs() <= bound).all())
    assert not bool(((shifted - SB.wgrad_16bit(x, g).double()).abs() <= bound).all())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_tensors_launch_the_op_kernels():
    dev = _card()
    FC.reset_launch_counts()
    TOPS.reset_launch_counts()
    x = torch.randn(64, 96, device=dev)
    FC.fp8_cast_tensorwise(x, x.abs().amax(), "e4m3")
    FC.fp8_cast_tensorwise(x.bfloat16(), x.abs().amax(), "e5m2")
    TOPS.wgrad_bf16(x, torch.randn(64, 32, device=dev))
    torch.cuda.synchronize()
    assert FC.launch_counts() == {"fp8_cast_tensorwise": 2}
    assert TOPS.launch_counts()["wgrad_bf16"] == 1
    with pytest.raises(ValueError):                 # mixed devices
        FC.fp8_cast_tensorwise(x, torch.tensor(1.0))


# ---------------------------------------------------------------------------
# the tensor quantizers, int8 and fp8: one skeleton (kernels/csrc/
# tensor_absmax.cuh), x read once into the resident blocks' registers and
# their maxima met at one grid barrier in one cooperative launch
# ---------------------------------------------------------------------------

# every weight of the serve and train paths: smollm's seven a layer, CLIP's
# vision and text layers' six and the patch embedding
TQ_PATH = [(960, 960), (960, 320), (960, 2560), (2560, 960), (1280, 1280), (1280, 5120),
           (5120, 1280), (1024, 1024), (1024, 4096), (4096, 1024), (588, 1280)]
# ragged and small: n = 1, 7, 9, 15; 257 chunks (two blocks); 33 blocks;
# ~700 K values with n % 8 = 5
TQ_SMALL = [(1, 1), (1, 7), (1, 9), (3, 5), (1, 2049), (1, 65541), (7, 100003)]


def _tq_family(family):
    """(kernel, plain, control fault, plan) of one quantizer family: int8
    or an fp8 format."""
    if family == "int8":
        return (TOPS.tensor_quantize, TREF.tensor_quantize, TOPS.tensor_quantize_drop,
                TOPS.tensor_quantize_plan)
    return (lambda x: F8.tensor_quantize(x, family), lambda x: F8REF.tensor_quantize(x, family),
            lambda x, b: F8.tensor_quantize_drop(x, family, b), F8.tensor_quantize_plan)


def _tq_input(gen, R, C, dev, dt, family, at, offset=0):
    """Random values over many binades below the absmax A (127 for int8, 1
    for fp8: the scale is then exact), A itself (negative at odd ``at``) at
    the flat index ``at`` alone, and where room allows a stretch of exact
    rounding ties at that scale (int8: k + 0.5; fp8: k / 64, midpoints of
    both grids) and of bf16 subnormals. ``offset``: the elements the view
    starts after its buffer's start."""
    n = R * C
    A = 127.0 if family == "int8" else 1.0
    x = torch.randn(n, generator=gen, device=dev)
    x = x * torch.exp(torch.empty(n, device=dev).uniform_(-4, 4, generator=gen))
    x = x / x.abs().max() * (0.9 * A)
    if n >= 1024:
        k = torch.arange(256, device=dev, dtype=torch.float32)
        ties = (k % 8) - 3.5 if family == "int8" else ((k % 127) - 63) / 64
        x[n // 3:n // 3 + 256] = ties
        x[n // 2:n // 2 + 7] = (torch.arange(7, device=dev) - 3).float() * 2.0 ** -133
    x[at] = -A if at % 2 else A
    x = x.to(dt)
    if offset:
        buf = torch.empty(n + offset, dtype=dt, device=dev)
        buf[offset:] = x
        x = buf[offset:]
    return x.view(R, C)


def _tq_block_of(i, n, blocks):
    """The block whose span holds flat index i: block b owns the chunks of
    8 values [b C / B, (b + 1) C / B)."""
    chunks = -(-n // 8)
    lo = [b * chunks // blocks for b in range(blocks)]
    return int(np.searchsorted(lo, i // 8, side="right")) - 1


def _tq_holds(quant, plain, x, what):
    got, again, want = quant(x), quant(x), plain(x)
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w)), what
        assert torch.equal(_bits(g), _bits(a)), what
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["int8", "e4m3", "e5m2"])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_tensor_quantizers_match_plain_at_the_edges(family, dt):
    """Each tensor quantizer bit-equal to its plain version (codes and
    state) at every path weight, ragged and small n, n one granule either
    side of the one-launch limit and the limit itself, from offsets 0, 1,
    2 and 4 elements (every granule); the absmax first, last, inside the
    last block's span and at a span's edge, negative at odd places; an
    all-zero tensor (state 1e-12). Twice the same bits. Every path weight
    in bf16 takes the one launch. The control fault (the absmax's block's
    partial left out) differs from the plain version in every case with
    more than one block."""
    dev = _card()
    quant, plain, drop, plan = _tq_family(family)
    gen = torch.Generator(device=dev).manual_seed(7)
    limit = plan(torch.empty((1, 8), dtype=dt, device=dev))
    L = limit["resident"] * limit["block_values"]
    shapes = TQ_PATH + TQ_SMALL + [(1, L - 8), (1, L - 3), (1, L), (1, L + 8)]
    for R, C in shapes:
        n = R * C
        p = plan(torch.empty((R, C), dtype=dt, device=dev))
        assert p["rounds"] == (0 if n <= L else 2), (R, C, p)
        if (R, C) in TQ_PATH and dt == torch.bfloat16:
            assert p["rounds"] == 0, (R, C, p)
        last = 8 * ((p["blocks"] - 1) * -(-n // 8) // p["blocks"])    # the last span's first
        spots = {"first": 0, "last": n - 1, "last block": min(n - 1, last + (n - last) // 2),
                 "span edge": max(0, min(n - 1, last - 1))}
        for offset in (0, 1, 2, 4):
            for where, at in (spots.items() if offset == 0 else [("last block",
                                                                  spots["last block"])]):
                x = _tq_input(gen, R, C, dev, dt, family, at, offset)
                want = _tq_holds(quant, plain, x, (R, C, offset, where))
                if offset == 0 and p["blocks"] > 1:
                    q_f, s_f = drop(x, _tq_block_of(at, n, p["blocks"]))
                    assert not (torch.equal(_bits(q_f), _bits(want[0]))
                                and torch.equal(s_f, want[1])), (R, C, where)
        zero = torch.zeros((R, C), dtype=dt, device=dev)
        assert float(_tq_holds(quant, plain, zero, (R, C, "zero"))[1]) == float(np.float32(1e-12))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["int8", "e4m3"])
def test_cuda_tensor_quantizers_capture_and_replay(family):
    """A captured CUDA graph of the cooperative launch replays to the same
    bytes as the eager call, and to the plain version's on new values in
    the same buffer."""
    dev = _card()
    quant, plain, _, _ = _tq_family(family)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = _tq_input(gen, 1280, 5120, dev, torch.bfloat16, family, 12345)
    eager = quant(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        quant(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = quant(x)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for g, e in zip(out, eager):
            assert torch.equal(_bits(g), _bits(e))
    x.copy_(_tq_input(gen, 1280, 5120, dev, torch.bfloat16, family, 999))
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(out, plain(x)):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.cuda
def test_cuda_tensor_quantizers_one_kernel_a_call():
    """Every path weight in bf16 takes one CUDA kernel a call (the one
    launch), counted exactly as the kernel nodes of a CUDA graph that
    captures the calls (``build.graph_kernels``; torch.profiler's records
    can go missing), and the wrappers count one launch a call."""
    from repro_torch.kernels import build as KB
    dev = _card()
    ws = [torch.randn(s, device=dev).to(torch.bfloat16) for s in TQ_PATH]
    calls = [lambda w: TOPS.tensor_quantize(w), lambda w: F8.tensor_quantize(w, "e4m3"),
             lambda w: F8.tensor_quantize(w, "e5m2")]
    for call in calls:
        call(ws[0])
    torch.cuda.synchronize()
    TOPS.reset_launch_counts()
    F8.reset_launch_counts()
    fp8 = len(KB.graph_kernels(lambda: [calls[i](w) for i in (1, 2) for w in ws]))
    int8 = len(KB.graph_kernels(lambda: [calls[0](w) for w in ws]))
    assert fp8 == 2 * len(ws) and int8 == len(ws), (fp8, int8)
    # graph_kernels runs each call twice (once to warm the capture stream)
    assert TOPS.launch_counts()["tensor_quantize"] == 2 * len(ws)
    assert F8.launch_counts()["fp8_tensor_quantize"] == 4 * len(ws)


# the expert-batched forms at qwen3-moe-30b-a3b's expert shapes (E = 128,
# d_model 2,048, expert d_ff 768) at decode's C = 4 and a train-size C =
# 160, and small ragged ones (C either side of 16, K off 16 bytes)
BATCHED_CASES = [(128, 4, 2048, 768), (128, 160, 2048, 768), (128, 4, 768, 2048),
                 (128, 160, 768, 2048), (8, 16, 130, 70), (8, 17, 130, 70), (3, 1, 96, 128),
                 (5, 300, 256, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,K,M", BATCHED_CASES)
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_batched_switchback_matches_plain_and_the_2d_loop(E, C, K, M, dt):
    """The three expert-batched forms (``tensor_quantize_batched``,
    ``fused_switchback_fwd_batched``, ``fused_switchback_dgrad_batched``)
    bit-equal to their plain versions and to a loop of the 2-D kernels over
    the experts, twice the same bits, one wrapper launch a call, the
    K-split workspace left zero."""
    dev = _card()
    rng = np.random.default_rng(E * C + K + M)
    x = torch.from_numpy(rng.standard_normal((E, C, K)).astype(np.float32) * 3).to(dev, dt)
    x[0, 0] = 0.0                                      # an all-zero row (an empty slot)
    w = torch.from_numpy(rng.standard_normal((E, K, M)).astype(np.float32)
                         * np.linspace(0.5, 2.0, E, dtype=np.float32)[:, None, None]
                         ).to(dev, torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((E, C, M)).astype(np.float32)).to(dev, dt)
    TOPS.reset_launch_counts()
    w_q, s_w = TOPS.tensor_quantize_batched(w)
    fwd = TOPS.fused_switchback_fwd_batched(x, w_q, s_w)
    dgr = TOPS.fused_switchback_dgrad_batched(g, w_q, s_w)
    assert TOPS.launch_counts()["tensor_quantize_batched"] == 1
    assert TOPS.launch_counts()["fused_switchback_fwd_batched"] == 1
    assert TOPS.launch_counts()["fused_switchback_dgrad_batched"] == 1
    rq, rs = TREF.tensor_quantize_batched(w)
    assert torch.equal(w_q, rq) and torch.equal(s_w, rs)
    assert torch.equal(fwd, TREF.fused_switchback_fwd_batched(x, w_q, s_w))
    assert torch.equal(dgr, TREF.fused_switchback_dgrad_batched(g, w_q, s_w))
    for e in range(E):
        q2, s2 = TOPS.tensor_quantize(w[e])
        assert torch.equal(q2, w_q[e]) and torch.equal(s2, s_w[e])
        assert torch.equal(TOPS.fused_switchback_fwd(x[e], w_q[e], s_w[e]), fwd[e])
        assert torch.equal(TOPS.fused_switchback_dgrad(g[e], w_q[e], s_w[e]), dgr[e])
    assert torch.equal(TOPS.fused_switchback_fwd_batched(x, w_q, s_w), fwd)       # rerun
    assert torch.equal(TOPS.fused_switchback_dgrad_batched(g, w_q, s_w), dgr)
    assert not any(bool(b.any()) for b in TOPS._SPLIT.values())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_expert_matmul_launches_the_batched_kernels():
    """``int8_switchback``'s expert matmul (forward and backward) runs the
    three batched kernels once each and no 2-D SwitchBack kernel: no
    Python loop over experts launches a kernel; its outputs and Ẋ equal
    the 2-D ``SwitchBackMatmul`` looped over experts, Ẇ within the f32
    sum order of cuBLAS's batched and 2-D GEMMs."""
    dev = _card()
    rng = np.random.default_rng(7)
    E, C, K, M = 128, 160, 2048, 768
    x = torch.from_numpy(rng.standard_normal((E, C, K)).astype(np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((E, K, M)).astype(np.float32) * 0.02).to(dev)
    g = torch.from_numpy(rng.standard_normal((E, C, M)).astype(np.float32)).to(dev, torch.bfloat16)
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    TOPS.reset_launch_counts()
    y = SB.expert_matmul(xa, wa, compute_dtype=torch.bfloat16)
    y.backward(g)
    counts = TOPS.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "tensor_quantize_batched": 1, "fused_switchback_fwd_batched": 1,
        "fused_switchback_dgrad_batched": 1}, counts
    for e in (0, 77, E - 1):
        xe, we = x[e].clone().requires_grad_(True), w[e].clone().requires_grad_(True)
        ye = SB.SwitchBackMatmul.apply(xe, we, torch.bfloat16, "switchback")
        ye.backward(g[e])
        assert torch.equal(ye, y[e]) and torch.equal(xe.grad, xa.grad[e])
        tol = 1e-5 * float(we.grad.abs().max())
        assert float((we.grad - wa.grad[e]).abs().max()) <= tol


@pytest.mark.cuda
def test_cuda_clip_remat_is_bit_equal_to_none():
    """CLIP ViT-H/14 at full width and 2 + 2 layers, int8_switchback with
    zero-init layer-scale, batch 8, 3 steps: under ``remat="block"`` the
    losses and every parameter are ``"none"``'s bits (each block's forward
    recomputed in the backward by the same kernels)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.precision import QuantPolicy, full_precision_products
    from repro_torch.data import SyntheticCLIP
    from repro_torch.models import build
    from repro_torch.models import params as PRM
    from repro_torch.train import init_train_state, make_train_setup, make_train_step
    dev = _card()
    full_precision_products()
    cfg = dataclasses.replace(get_config("clip-vit-huge"), vision_layers=2, text_layers=2,
                              layer_scale_init=0.0)
    data = SyntheticCLIP(cfg.image_size, cfg.text_ctx, cfg.text_vocab, n_classes=32, seed=5)
    batches = [{"images": torch.from_numpy(b["images"]).to(dev),
                "texts": torch.from_numpy(b["texts"]).to(device=dev, dtype=torch.long)}
               for b in (data.batch(8) for _ in range(3))]
    runs = {}
    for remat in ("none", "block"):
        tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                         quant_mode="int8_switchback")
        opt, scaler = make_train_setup(tc)
        bundle = build(cfg)
        step = make_train_step(bundle, QuantPolicy("int8_switchback"),
                               ParallelConfig(remat=remat), tc, opt, scaler)
        state = init_train_state(PRM.init_params(bundle.param_specs, 0, device=dev), opt, scaler)
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        runs[remat] = (losses, state.params)
    torch.cuda.synchronize()
    (l0, p0), (l1, p1) = runs["none"], runs["block"]
    assert l0 == l1
    for (path, a), (_, b) in zip(PRM.tree_paths(p0), PRM.tree_paths(p1)):
        assert torch.equal(a, b), path


@pytest.mark.cuda
def test_cuda_appendix_c_product_is_the_plain_function():
    """App. C's Eq. 3 product on the card goes through the row_quantize,
    tensor_quantize and int8_matmul_dequant_t kernels (counted), and gives
    the plain functions' bits on the same card tensors; the reference's
    criteria hold at the CLIP widths."""
    from repro_torch.core import analysis as AN
    from repro_torch.core import quantization as Q
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((256, 1280), generator=gen, device=dev)
    w = torch.randn((256, 1280), generator=gen, device=dev)
    TOPS.reset_launch_counts()
    x_q, s_x, w_q, s_w, approx = AN.eq3_product(x, w)
    counts = TOPS.launch_counts()
    assert all(counts[k] == 1 for k in ("row_quantize", "tensor_quantize",
                                        "int8_matmul_dequant_t"))
    qx, sx = Q.quantize_rowwise(x)
    qw, sw = Q.quantize_tensorwise(w)
    assert torch.equal(x_q, qx) and torch.equal(s_x, sx)
    assert torch.equal(w_q, qw) and torch.equal(s_w.reshape(()), sw)
    assert torch.equal(approx, Q.int8_matmul_dequant_rowwise_tensorwise(qx, qw, sx, sw))
    small = AN.empirical_matmul_quant_error(gen, 256, 1280, 256)
    large = AN.empirical_matmul_quant_error(gen, 256, 5120, 256)
    assert large[0] > small[0]
    assert all(0.3 <= m / p <= 3.0 for m, p in (small, large))
