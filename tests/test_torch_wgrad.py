"""The port's ``wgrad_bf16`` against the JAX package's, on the CPU.

On CPU tensors ``kernels/switchback/ops.wgrad_bf16`` runs its plain
version (``ref.py``): x (B, K) and g (B, M) rounded to bf16, Ẇ = xᵀ g in
f32 with each output the sum of its B products in order b = 0, 1, ...
The CUDA kernel sums on bf16 wgmma, within ``ref.wgrad_bound`` of it
(``chip_smoke.py`` phase 27 and ``tests/test_torch_cuda.py`` hold that on
the card; ``tests/test_torch_wgrad_bound.py`` the bound and the model of
the tensor cores' sums). Here, on inputs made from a seeded numpy
generator:

* against the JAX package's Pallas kernel in interpret mode and its XLA
  path (``dot_general``), at that package's test shapes
  (``tests/test_kernels.py``) and past one 512-row block, bf16 and f32
  inputs, and against the port's training-path product
  (``core/switchback.wgrad_16bit``), within a bound: two orders of
  summing B exact products differ by at most B · 2^-23 · (|x|ᵀ|g|)
  elementwise (each order's error is below (B - 1) · 2^-24 of the sum of
  the magnitudes);
* bit for bit against an independent numpy loop of f32 outer products in
  b order;
* the order is pinned: on a constructed case the in-order sum and the sum
  over permuted rows give different bits, and the port gives the first.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.switchback import ops as JK
from repro_torch.core import switchback as SB
from repro_torch.kernels.switchback import ops as TOPS

torch.set_num_threads(1)

# the JAX package's SHAPES (B, K, M) and one past its 512-row block
SHAPES = [(8, 128, 64), (256, 256, 256), (300, 640, 200), (64, 2048, 128), (513, 384, 96),
          (1030, 130, 70)]
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


def _inputs(B, K, M, seed):
    """x (B, K), g (B, M) f32 over a few binades, an all-zero row of x."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, K)) * np.exp(rng.uniform(-2, 2, (B, 1)))
    g = rng.standard_normal((B, M)) * np.exp(rng.uniform(-2, 2, (B, 1)))
    x[B // 2] = 0.0
    return x.astype(np.float32), g.astype(np.float32)


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).bfloat16().float().numpy()


def _within_bound(got, want, x, g):
    """|got - want| <= B · 2^-23 · (|x|ᵀ|g|) elementwise (x, g in bf16)."""
    B = x.shape[0]
    xb, gb = _bf16(x).astype(np.float64), _bf16(g).astype(np.float64)
    bound = B * 2.0 ** -23 * (np.abs(xb).T @ np.abs(gb))
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(diff <= bound), float((diff / np.maximum(bound, 1e-300)).max())


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("B,K,M", SHAPES)
def test_wgrad_bf16_within_the_bound_of_jax(B, K, M, dt):
    tdt, jdt = DTYPES[dt]
    x, g = _inputs(B, K, M, B * 3 + K + M)
    got = TOPS.wgrad_bf16(torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt))
    assert got.dtype == torch.float32 and tuple(got.shape) == (K, M)
    for backend in ("pallas_interpret", "xla"):
        want = JK.wgrad_bf16(jnp.asarray(x, jdt), jnp.asarray(g, jdt), backend=backend)
        _within_bound(got.numpy(), np.asarray(want), x, g)
    _within_bound(got.numpy(), SB.wgrad_16bit(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
                  x, g)


@pytest.mark.parametrize("B,K,M", [(1, 3, 5), (37, 70, 33), (513, 96, 40)])
def test_wgrad_bf16_is_the_in_order_f32_sum(B, K, M):
    """Bit for bit an independent numpy loop: one f32 outer product (exact)
    and one f32 add per row, rows in order."""
    x, g = _inputs(B, K, M, B + K + M)
    xb, gb = _bf16(x), _bf16(g)
    acc = np.zeros((K, M), np.float32)
    for b in range(B):
        acc = acc + np.outer(xb[b], gb[b])
    got = TOPS.wgrad_bf16(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), acc.view(np.int32))


def test_wgrad_bf16_pins_the_order_of_the_sum():
    """g's rows 2^24, 1, -2^24 against x = 1: in order 2^24 + 1 rounds to
    2^24 (a tie, to even) and the sum is 0; with the last two rows swapped
    it is 1. The port gives 0, and 1 for the permuted rows: the order of the
    B rows is part of the function."""
    x = torch.ones(3, 1)
    g = torch.tensor([[2.0 ** 24], [1.0], [-(2.0 ** 24)]])
    assert float(TOPS.wgrad_bf16(x, g)) == 0.0
    perm = torch.tensor([0, 2, 1])
    assert float(TOPS.wgrad_bf16(x[perm], g[perm])) == 1.0


def test_wgrad_bf16_wrapper_checks_and_counts_no_cpu_launch():
    TOPS.reset_launch_counts()
    with pytest.raises(ValueError):
        TOPS.wgrad_bf16(torch.ones(4, 3), torch.ones(5, 2))       # rows differ
    with pytest.raises(ValueError):
        TOPS.wgrad_bf16(torch.ones(4), torch.ones(4, 2))
    with pytest.raises(TypeError):
        TOPS.wgrad_bf16(torch.ones(4, 3, dtype=torch.int8), torch.ones(4, 2))
    out = TOPS.wgrad_bf16(torch.ones(4, 3, dtype=torch.float16), torch.ones(4, 2))
    assert out.dtype == torch.float32 and torch.equal(out, torch.full((3, 2), 4.0))
    assert torch.equal(TOPS.wgrad_bf16(torch.ones(0, 3), torch.ones(0, 2)), torch.zeros(3, 2))
    assert set(TOPS.launch_counts().values()) == {0}
    assert "wgrad_bf16" in TOPS.launch_counts()
