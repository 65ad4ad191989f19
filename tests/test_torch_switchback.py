"""The port's SwitchBack kernel module against the JAX package's.

``repro_torch.kernels.switchback.ops`` on CPU tensors runs the plain
PyTorch versions; they are held bit for bit against the JAX package's
Pallas kernels (interpret mode) and its XLA reference on the same inputs,
made from a seeded numpy generator: small swept shapes, ragged edges,
exact half-way ties and an all-zero row. The CUDA kernels themselves run
only on the card: ``tests/test_torch_cuda.py`` (marker ``cuda``) holds
them against these plain versions there and skips elsewhere.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as JQ
from repro.kernels.switchback import ops as JOPS
from repro_torch.core import quantization as TQ
from repro_torch.core import switchback as TSB
from repro_torch.kernels.switchback import ops as TOPS
from repro_torch.kernels.switchback import ref as TREF

torch.set_num_threads(1)

JAX_BACKENDS = ("xla", "pallas_interpret")
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """Round an f32 array to bf16-representable values (still f32)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _activations(rng, B, K):
    """Random rows plus the rows the rounding rules hinge on."""
    x = _bf16_values(rng.standard_normal((B, K)).astype(np.float32) * 3)
    if B >= 3:
        # absmax 127 makes the scale exactly 1: every .5 is a tie
        ties = (np.arange(K, dtype=np.float32) % 8) - 3.5
        ties[0] = 127.0
        x[1] = ties
        x[2] = 0.0                                   # all-zero row
    return x


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _same(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


ROW_SHAPES = [(1, 8), (5, 40), (9, 130), (300, 64)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("B,K", ROW_SHAPES)
def test_row_quantize_matches_jax(B, K, dt):
    rng = np.random.default_rng(B * 1000 + K)
    x = _activations(rng, B, K)
    jdt, tdt = DTYPES[dt]
    q, s = TOPS.row_quantize(torch.from_numpy(x).to(tdt))
    assert q.dtype == torch.int8 and s.shape == (B, 1)
    for backend in JAX_BACKENDS:
        jq, js = JOPS.row_quantize(jnp.asarray(x).astype(jdt), backend=backend)
        _same(q, jq)
        _same(s, js)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("R,C", [(1, 8), (40, 24), (600, 130)])
def test_tensor_quantize_matches_jax(R, C, dt):
    rng = np.random.default_rng(R * 1000 + C)
    w = _bf16_values(rng.standard_normal((R, C)).astype(np.float32) * 0.05)
    if R > 1:
        w[0, 0] = 127.0 * 0.01                       # scale 100: x.5e-2 ties
        w[1, : min(C, 8)] = 0.01 * ((np.arange(min(C, 8)) % 4) + 0.5)
    w = _bf16_values(w)
    jdt, tdt = DTYPES[dt]
    q, s = TOPS.tensor_quantize(torch.from_numpy(w).to(tdt))
    assert s.shape == (1, 1)
    for backend in JAX_BACKENDS:
        jq, js = JOPS.tensor_quantize(jnp.asarray(w).astype(jdt), backend=backend)
        _same(q, jq)
        _same(s, js)


def test_tensor_quantize_all_zero():
    """q is all zeros everywhere. The state floors at 1e-12 as in the XLA
    reference; the Pallas kernel returns its unfloored absmax 0 (it floors
    only inside the cast), a difference no output can see: every product
    with an all-zero W is 0."""
    w = np.zeros((16, 8), np.float32)
    q, s = TOPS.tensor_quantize(torch.from_numpy(w))
    jq, js = JOPS.tensor_quantize(jnp.asarray(w), backend="xla")
    _same(q, jq)
    _same(s, js)
    pq, ps = JOPS.tensor_quantize(jnp.asarray(w), backend="pallas_interpret")
    _same(q, pq)
    assert float(np.asarray(ps)[0, 0]) == 0.0
    assert float(s[0, 0]) == np.float32(1e-12)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", [(5, 40), (2, 9, 130)])
def test_core_quantizers_match_jax(shape, dt):
    """core/quantization's int8 quantizers and dequantizers, bit for bit
    against the JAX package's (leading dims included)."""
    rng = np.random.default_rng(sum(shape))
    x = _bf16_values(rng.standard_normal(shape).astype(np.float32) * 2)
    x.reshape(-1, shape[-1])[1] = 0.0                  # an all-zero row
    jdt, tdt = DTYPES[dt]
    tx, jx = torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)
    for tq, jq in ((TQ.quantize_rowwise, JQ.quantize_rowwise),
                   (TQ.quantize_tensorwise, JQ.quantize_tensorwise)):
        (q, s), (rq, rs) = tq(tx), jq(jx)
        _same(q, rq)
        _same(s, rs)
        assert tuple(s.shape) == rs.shape
    q, s = TQ.quantize_rowwise(tx)
    _same(TQ.dequantize_rowwise(q, s), JQ.dequantize_rowwise(*JQ.quantize_rowwise(jx)))
    q, s = TQ.quantize_tensorwise(tx)
    _same(TQ.dequantize_tensorwise(q, s, torch.bfloat16),
          JQ.dequantize_tensorwise(*JQ.quantize_tensorwise(jx), jnp.bfloat16))


GEMM_SHAPES = [(1, 8, 4), (5, 40, 24), (17, 130, 70), (260, 64, 33)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("B,K,M", GEMM_SHAPES)
def test_fused_switchback_fwd_matches_jax(B, K, M, dt):
    rng = np.random.default_rng(B * 10000 + K * 100 + M)
    x = _activations(rng, B, K)
    w_q = rng.integers(-127, 128, size=(K, M), dtype=np.int8)
    s_w = np.array([[rng.uniform(0.1, 3.0)]], np.float32)
    jdt, tdt = DTYPES[dt]
    y = TOPS.fused_switchback_fwd(torch.from_numpy(x).to(tdt),
                                  torch.from_numpy(w_q), torch.from_numpy(s_w))
    assert y.dtype == tdt and y.shape == (B, M)
    for backend in JAX_BACKENDS:
        jy = JOPS.fused_switchback_fwd(jnp.asarray(x).astype(jdt), jnp.asarray(w_q),
                                       jnp.asarray(s_w), out_dtype=jdt,
                                       backend=backend)
        _same(y, jy)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("B,K,M", GEMM_SHAPES)
def test_int8_matmul_dequant_matches_jax(B, K, M, dt):
    rng = np.random.default_rng(B * 10000 + K * 100 + M + 7)
    x_q = rng.integers(-127, 128, size=(B, K), dtype=np.int8)
    w_q = rng.integers(-127, 128, size=(K, M), dtype=np.int8)
    row_scale = rng.uniform(1e-5, 1e-3, size=(B, 1)).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    y = TOPS.int8_matmul_dequant(torch.from_numpy(x_q), torch.from_numpy(w_q),
                                 torch.from_numpy(row_scale), out_dtype=tdt)
    for backend in JAX_BACKENDS:
        jy = JOPS.int8_matmul_dequant(jnp.asarray(x_q), jnp.asarray(w_q),
                                      jnp.asarray(row_scale), out_dtype=jdt,
                                      backend=backend)
        _same(y, jy)


@pytest.mark.parametrize("K", [64, 2304])
def test_switchback_forward_matches_jax(K):
    """The layer forward (core/switchback) on both sides of
    FUSED_MAX_CONTRACT: fused kernel below it, row-quantize + tiled matmul
    above it, bit-equal to the JAX package's Pallas path either way."""
    from repro.core import switchback as JSB
    rng = np.random.default_rng(K)
    x = _activations(rng, 6, K)
    w = _bf16_values(rng.standard_normal((K, 40)).astype(np.float32) / np.sqrt(K))
    y = TSB.switchback_linear(torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(w).to(torch.bfloat16))
    for backend in JAX_BACKENDS:
        jy = JSB.switchback_linear(jnp.asarray(x).astype(jnp.bfloat16),
                                   jnp.asarray(w), backend=backend)
        _same(y, jy)


def test_quantizers_round_half_to_even_and_divide_first():
    """The two rules the kernels copy: ties go to even, and the scale is
    one IEEE division 127/absmax (``127.0 / t`` in torch would be
    reciprocal(t) * 127, two roundings)."""
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.0]])
    q, _ = TREF.row_quantize(x)
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2, 0]]
    absmax = torch.tensor([[3.0]])
    assert torch.equal(torch.full_like(absmax, 127.0) / absmax,
                       torch.tensor([[np.float32(127.0) / np.float32(3.0)]]))


def test_dispatch_rejects_bad_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        TOPS.row_quantize(x.to(torch.float16))
    with pytest.raises(ValueError):
        TOPS.row_quantize(x.t())                     # not contiguous
    with pytest.raises(ValueError):
        TOPS.fused_switchback_fwd(x, torch.zeros(9, 3, dtype=torch.int8),
                                  torch.ones(1, 1))
    with pytest.raises(ValueError):
        TOPS.int8_matmul_dequant(torch.zeros(4, 8, dtype=torch.int8),
                                 torch.zeros(8, 3, dtype=torch.int8),
                                 torch.ones(3, 1))


def test_cpu_tensors_never_count_launches():
    TOPS.reset_launch_counts()
    x = torch.randn(4, 16)
    w_q, s_w = TOPS.tensor_quantize(torch.randn(16, 8))
    TOPS.fused_switchback_fwd(x, w_q, s_w)
    x_q, s_x = TOPS.row_quantize(x)
    TOPS.int8_matmul_dequant(x_q, w_q, s_x * (s_w / 16129.0), out_dtype=torch.float32)
    assert set(TOPS.launch_counts().values()) == {0}
