"""The port's CUDA kernels on the card (marker ``cuda``).

These tests import no JAX, so they run on a machine with the card and
without JAX (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py

Elsewhere they skip. Each kernel must be bit-equal to its plain PyTorch
version (``kernels/switchback/ref.py``) on the same inputs at the serve
path's shapes, and a CUDA tensor must go to the kernel, never to the plain
version. ``chip_smoke.py`` runs the same checks inside its end-to-end run.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.switchback import ops as TOPS
from repro_torch.kernels.switchback import ref as TREF


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
def test_cuda_tensors_launch_the_kernels():
    dev = _card()
    TOPS.reset_launch_counts()
    x = torch.randn(4, 64, device=dev, dtype=torch.bfloat16)
    w_q, s_w = TOPS.tensor_quantize(torch.randn(64, 32, device=dev))
    TOPS.fused_switchback_fwd(x, w_q, s_w)
    x_q, s_x = TOPS.row_quantize(x)
    TOPS.int8_matmul_dequant(x_q, w_q, s_x * TREF.div(s_w, 16129.0))
    torch.cuda.synchronize()
    assert TOPS.launch_counts() == {k: 1 for k in TOPS.launch_counts()}
    with pytest.raises(ValueError):                 # mixed devices
        TOPS.fused_switchback_fwd(x, w_q.cpu(), s_w)
