"""The port's CUDA kernels on the card (marker ``cuda``).

These tests import no JAX, so they run on a machine with the card and
without JAX (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py

Elsewhere they skip. Each SwitchBack kernel, forward and input gradient,
must be bit-equal to its plain PyTorch version
(``kernels/switchback/ref.py``) on the same inputs at the serve and train
paths' shapes; each flash-attention forward kernel must agree with its
plain version (``kernels/flash_attention/ref.py``, one full softmax where
the kernel takes an online one) within o 2^-7 of max|o| in bf16 (one bf16
ulp at the largest value) and 1e-5 in f32, lse 1e-5 absolute; the two
backward kernels within BWD_TOL of max|grad| of theirs (the same
recomputed p, sums in another order), and bit-identical over two
launches. A CUDA tensor must go to the kernel, never to the plain version.
``chip_smoke.py`` runs the same checks inside its end-to-end run.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention import ref as FREF
from repro_torch.kernels.switchback import ops as TOPS
from repro_torch.kernels.switchback import ref as TREF

O_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
LSE_TOL = 1e-5
# backward kernels vs plain, relative to max|grad|: the inputs are exact in
# both types and both sides compute in f32, so the gap is the order of f32
# sums over keys and rows (about 1e-6); bf16 inputs carry the same
BWD_TOL = {torch.bfloat16: 1e-4, torch.float32: 1e-4}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _activations(rng, B, K):
    x = rng.standard_normal((B, K)).astype(np.float32) * 3
    ties = (np.arange(K, dtype=np.float32) % 8) - 3.5
    ties[0] = 127.0                      # scale 1: every .5 is a tie
    x[1] = ties
    x[2] = 0.0                           # all-zero row
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,M", [(8, 960, 320), (8, 2560, 960),
                                   (1024, 960, 2560), (37, 130, 70)])
def test_cuda_kernels_match_plain(B, K, M):
    dev = _card()
    rng = np.random.default_rng(B * K + M)
    x = _activations(rng, B, K).to(dev)
    w = torch.from_numpy(rng.standard_normal((K, M)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    w_q, s_w = TOPS.tensor_quantize(w)
    rq, rs = TREF.tensor_quantize(w)
    assert torch.equal(w_q, rq) and torch.equal(s_w, rs)
    assert torch.equal(TOPS.fused_switchback_fwd(x, w_q, s_w),
                       TREF.fused_switchback_fwd(x, w_q, s_w))
    x_q, s_x = TOPS.row_quantize(x)
    rxq, rsx = TREF.row_quantize(x)
    assert torch.equal(x_q, rxq) and torch.equal(s_x, rsx)
    scale = s_x * TREF.div(s_w, 16129.0)
    assert torch.equal(TOPS.int8_matmul_dequant(x_q, w_q, scale),
                       TREF.int8_matmul_dequant(x_q, w_q, scale))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,N", [(2048, 960, 960), (2048, 320, 960), (2048, 960, 2560),
                                   (1000, 2560, 960), (8, 2560, 960), (37, 70, 130)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_dgrad_kernels_match_plain(B, M, N, dt):
    """The dgrad pair at the train path's shapes: g (B, M) against the
    forward's w_q (N, M), contracted over M."""
    dev = _card()
    rng = np.random.default_rng(B * M + N)
    g = _activations(rng, B, M).to(dev, dt)
    w = torch.from_numpy(rng.standard_normal((N, M)).astype(np.float32)
                         ).to(dev, torch.bfloat16)
    w_q, s_w = TOPS.tensor_quantize(w)
    want = TREF.fused_switchback_dgrad(g, w_q, s_w)
    got = TOPS.fused_switchback_dgrad(g, w_q, s_w)
    assert got.dtype == dt and torch.equal(got, want)
    assert torch.equal(TOPS.fused_switchback_dgrad(g, w_q, s_w), got)   # rerun
    g_q, s_g = TOPS.row_quantize(g)
    scale = s_g * TREF.div(s_w, 16129.0)
    want = TREF.int8_matmul_dequant_t(g_q, w_q, scale, out_dtype=dt)
    got = TOPS.int8_matmul_dequant_t(g_q, w_q, scale, out_dtype=dt)
    assert torch.equal(got, want)
    torch.cuda.synchronize()


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
    torch.cuda.synchronize()
    counts = TOPS.launch_counts()
    assert counts == {k: 1 for k in counts}
    assert set(counts) == {"tensor_quantize", "fused_switchback_fwd", "row_quantize",
                           "int8_matmul_dequant", "fused_switchback_dgrad",
                           "int8_matmul_dequant_t"}
    with pytest.raises(ValueError):                 # mixed devices
        TOPS.fused_switchback_fwd(x, w_q.cpu(), s_w)


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
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
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("S", [96, 256])
def test_cuda_decode_matches_plain(S, dt):
    dev = _card()
    lens = torch.tensor([1, 2, 127, 128, 129, 200, S, S // 2], dtype=torch.int32,
                        device=dev).clamp(max=S)
    gen = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn((8, 1, 15, 64), generator=gen, device=dev).to(dt)
    k = torch.randn((8, S, 5, 64), generator=gen, device=dev).bfloat16()
    v = torch.randn((8, S, 5, 64), generator=gen, device=dev).bfloat16()
    o = FA.decode_attention(q, k, v, lens)
    ro = FREF.decode_fwd(q, k, v, lens, scale=FA.softmax_scale(64))
    torch.cuda.synchronize()
    assert o.dtype == dt and _rel(o, ro) <= O_TOL[dt]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
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
