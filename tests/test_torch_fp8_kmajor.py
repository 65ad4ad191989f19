"""The fp8 forward's K-major W from the quantizer, on the CPU (no card, no
JAX; a few seconds).

``kernels/fp8_matmul/ops.tensor_quantize_kt`` gives ``tensor_quantize``'s
codes and state and the codes' bytes K-major (``w_k``), which the forward
GEMMs read in place of their own ``transpose_bytes`` copy
(``fp8_matmul_dequant(..., w_k=)``, ``mixed(..., w_k=)``). On a CPU tensor
each is the plain version: the quantizer ``ref.tensor_quantize`` and the
plain copy, the GEMMs the plain product of ``w_k`` viewed as the fp8 dtype
in the ``transpose_w`` form, which is the same function. So here:

* the plain K-major quantizer is ``tensor_quantize``'s q and state bit for
  bit, and its q's bytes transposed;
* both forward GEMMs given ``w_k`` equal the calls without it bit for bit,
  at the CLIP path's shapes cut in depth and at ragged ones, with outlier
  tiles that fall back; a wrong ``w_k`` (one row rolled) is caught;
* the wrappers refuse a ``w_k`` of the wrong shape or type and on the
  ``_t`` forms, and count no launch on the CPU;
* ``core/switchback``'s ``fp8`` and ``fp8_mixed`` forward (through the
  fold) gives the bits of the forward through ``tensor_quantize`` and the
  GEMMs without ``w_k``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import switchback as SB
from repro_torch.kernels.fp8_matmul import ops as F8
from repro_torch.kernels.fp8_matmul import ref as F8REF

torch.set_num_threads(1)

# (rows, K, M): a CLIP vision layer's widths at few rows, the patch
# embedding's K = 588, ragged
SHAPES = [(64, 1280, 1280), (48, 1280, 5120), (40, 5120, 1280), (36, 588, 1280), (37, 130, 70),
          (5, 37, 5)]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _bits(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _x(rng, R, C, dt, outliers=False):
    """Rows over several binades; with ``outliers`` a block of 1,000x
    values in the first columns of rows 16-31 (their tiles fall back in
    fp8_mixed at 16 x 16 tiles)."""
    x = rng.standard_normal((R, C)) * np.exp(rng.uniform(-4, 4, (R, 1)))
    if outliers and R > 31:
        x[16:32, :4] *= 1000.0
    return torch.from_numpy(x.astype(np.float32)).to(DTYPES[dt])


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("K,M", [(1280, 1280), (588, 1280), (130, 70), (37, 5), (1, 9)])
def test_plain_kt_is_tensor_quantize_and_its_transposed_bytes(K, M, dt, fmt):
    w = _x(np.random.default_rng(K * M), K, M, dt)
    F8.reset_launch_counts()
    q, s, q_k = F8.tensor_quantize_kt(w, fmt)
    rq, rs = F8.tensor_quantize(w, fmt)
    assert q.dtype == rq.dtype and torch.equal(_bits(q), _bits(rq)) and torch.equal(s, rs)
    assert q_k.dtype == torch.uint8 and tuple(q_k.shape) == (M, K) and q_k.is_contiguous()
    assert torch.equal(q_k, rq.view(torch.uint8).t().contiguous())
    assert torch.equal(_bits(q), _bits(F8REF.tensor_quantize(w, fmt)[0]))
    assert sum(F8.launch_counts().values()) == 0


def test_kt_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="empty"):
        F8.tensor_quantize_kt(torch.zeros((0, 4)))
    with pytest.raises(TypeError):
        F8.tensor_quantize_kt(torch.zeros((4, 4), dtype=torch.float16))
    with pytest.raises(ValueError, match="unknown fp8 format"):
        F8.tensor_quantize_kt(torch.zeros((4, 4)), "e3m4")
    with pytest.raises(ValueError, match="on the card"):
        F8.tensor_quantize_kt_fault(torch.ones((4, 4)), "e4m3", drop=0)


def _rolled(w_k):
    """w_k with its first row's bytes rolled by one: a wrong K-major W."""
    bad = w_k.clone()
    bad[0] = torch.roll(bad[0], 1)
    return bad


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("B,K,M", SHAPES)
def test_dequant_given_w_k_is_the_call_without_it(B, K, M, dt):
    rng = np.random.default_rng(B + K + M)
    w_q, s_w, w_k = F8.tensor_quantize_kt(_x(rng, K, M, dt), "e4m3")
    x_q, s_x = F8.row_quantize(_x(rng, B, K, dt), "e4m3")
    out = DTYPES[dt]
    want = F8.fp8_matmul_dequant(x_q, w_q, s_x * s_w, out_dtype=out)
    got = F8.fp8_matmul_dequant(x_q, w_q, s_x * s_w, out_dtype=out, w_k=w_k)
    assert got.dtype == want.dtype and torch.equal(got, want)
    bad = F8.fp8_matmul_dequant(x_q, w_q, s_x * s_w, out_dtype=out, w_k=_rolled(w_k))
    assert not torch.equal(bad, want)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("B,K,M", SHAPES)
def test_mixed_given_w_k_is_the_call_without_it(B, K, M, dt):
    """Both branches: 16 x 16 tiles, the outlier tiles in bf16."""
    rng = np.random.default_rng(3 * B + K + M)
    w_q, s_w, w_k = F8.tensor_quantize_kt(_x(rng, K, M, dt), "e4m3")
    x = _x(rng, B, K, dt, outliers=True)
    kw = dict(fmt="e4m3", block_rows=16, block_cols=16, fallback_ratio=8.0,
              out_dtype=DTYPES[dt])
    want = F8.mixed(x, w_q, s_w, **kw)
    got = F8.mixed(x, w_q, s_w, w_k=w_k, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert not torch.equal(F8.mixed(x, w_q, s_w, w_k=_rolled(w_k), **kw), want)
    if B > 31 and K > 16:
        x_q, s_blk = F8.block_quantize(x, "e4m3", 16, 16)
        assert float(F8.fallback_mask(s_blk, 8.0).sum()) > 0           # a tile fell back


def test_w_k_is_refused_where_it_does_not_fit():
    rng = np.random.default_rng(5)
    w_q, s_w, w_k = F8.tensor_quantize_kt(_x(rng, 64, 32, "f32"), "e4m3")
    x = _x(rng, 8, 64, "f32")
    x_q, s_x = F8.row_quantize(x, "e4m3")
    with pytest.raises(ValueError, match="transposed"):
        F8.fp8_matmul_dequant(x_q, w_q, s_x * s_w, w_k=w_k.t().contiguous())
    with pytest.raises(TypeError):
        F8.fp8_matmul_dequant(x_q, w_q, s_x * s_w, w_k=w_k.view(w_q.dtype))
    with pytest.raises(ValueError, match="_t forms"):
        F8.mixed(_x(rng, 8, 32, "f32"), w_q, s_w, transpose_w=True, w_k=w_k)


@pytest.mark.parametrize("variant", ["fp8", "fp8_mixed"])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_switchback_fp8_forward_through_the_fold(variant, dt):
    """The fp8 modes' forward (the fold, w_k handed to the GEMM) gives the
    bits of the same forward through ``tensor_quantize`` and the GEMM's own
    K-major copy; the backward reads the row-major w_q it saved. The f32
    weight is quantized from its f32 values, as the JAX package quantizes
    every weight it is handed (widened to f32)."""
    rng = np.random.default_rng(11)
    f = SB.FP8Config(block_rows=16, block_cols=16)
    x = _x(rng, 48, 96, dt, outliers=True).requires_grad_(True)
    w = _x(rng, 96, 40, "f32").requires_grad_(True)
    y = SB.switchback_linear(x, w, variant=variant, fp8=f)
    w_q, s_w = F8.tensor_quantize(w.detach(), f.fwd_fmt)
    if variant == "fp8":
        x_q, s_x = F8.row_quantize(x.detach(), f.fwd_fmt)
        want = F8.fp8_matmul_dequant(x_q, w_q, s_x * s_w, out_dtype=x.dtype)
    else:
        want = F8.mixed(x.detach(), w_q, s_w, fmt=f.fwd_fmt, block_rows=16, block_cols=16,
                        fallback_ratio=f.fallback_ratio, out_dtype=x.dtype)
    assert torch.equal(y.detach(), want)
    y.float().square().sum().backward()
    assert torch.isfinite(x.grad.float()).all() and torch.isfinite(w.grad).all()
