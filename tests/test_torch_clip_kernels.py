"""The CLIP slice's kernel modules against the JAX package's, on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions; they
are held against the JAX package's Pallas kernels in interpret mode and
its XLA reference on the same inputs, made from a seeded numpy generator:

* ``col_quantize`` (per-column int8, paper Eq. 4): bit for bit, f32 and
  bf16 inputs, ragged widths, half-way ties and an all-zero column;
* the colscale form of ``int8_matmul_dequant`` (the rank-1 ``row ⊗ col``
  epilogue) in both W orientations, ragged shapes, f32 and bf16 outputs:
  bit for bit;
* the SwitchBack variants ``switchback_m``, ``switchback_q`` and
  ``llm_int8`` as autograd functions: y, Ẋ and Ẇ against ``jax.vjp`` of
  ``make_switchback_matmul(variant, backend="pallas_interpret")`` bit
  for bit (the port follows the JAX kernel path). Against
  ``backend="xla"`` within stated tolerances: its column-wise variants
  multiply ``s_x * (s_w / 127²)`` where the kernel path multiplies
  ``(s_x / 127²) * s_w``, one f32 rounding apart, so y and Ẋ may differ
  by one ulp of the output type (Y_TOL of max|y|); the 16-bit Ẇ sums the
  same bf16 products in another order (DW_TOL);
* LLM.int8's int8 weight gradient: its int32 product exact against a
  numpy int64 sum, and Ẇ bit-equal to the JAX package's ``_wgrad_int8``;
* the differentiable flash attention at CLIP's attention form (MHA, no
  causal mask, head dim 80, and the text tower's causal hd 64) against
  ``jax.vjp`` of the JAX Pallas flash kernels (interpret), within one
  bf16 ulp of max|o| and max|grad|.

The CUDA kernels run only on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold them against these plain versions there.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import switchback as JSB
from repro.kernels.flash_attention import ops as JFA
from repro.kernels.switchback import ops as JOPS
from repro_torch.core import switchback as TSB
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.switchback import ops as TOPS

torch.set_num_threads(1)

JAX_BACKENDS = ("xla", "pallas_interpret")
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}
# y and Ẋ against the JAX XLA path (the scale's op order): one ulp of the
# output type at max|y|
Y_TOL = {"bf16": 2.0 ** -7, "f32": 2.0 ** -22}
DW_TOL = 1e-6
NEW_VARIANTS = ("switchback_m", "switchback_q", "llm_int8")


def _bf16_values(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _same(a, b, msg=""):
    np.testing.assert_array_equal(_np(a), _np(b), err_msg=msg)


def _rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _weight(rng, R, C):
    """A bf16-valued weight with an all-zero column and a column of exact
    half-way ties (absmax 127/128: scale 128, odd multiples of 1/256 land
    on .5)."""
    w = _bf16_values(rng.standard_normal((R, C)).astype(np.float32) / np.sqrt(R))
    if C >= 2 and R >= 3:
        w[:, 0] = 0.0
        w[:, 1] = ((2 * np.arange(R) - 15) % 31 - 15) / 256.0
        w[0, 1] = 127.0 / 128.0
    return w


# ---------------------------------------------------------------------------
# col_quantize and the colscale matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("R,C", [(1, 1), (7, 3), (40, 24), (96, 300), (33, 520)])
def test_col_quantize_matches_jax(R, C, dt):
    rng = np.random.default_rng(R * 1000 + C)
    w = _weight(rng, R, C)
    jdt, tdt = DTYPES[dt]
    q, s = TOPS.col_quantize(torch.from_numpy(w).to(tdt))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (R, C) and s.shape == (1, C)
    for backend in JAX_BACKENDS:
        jq, js = JOPS.col_quantize(jnp.asarray(w).astype(jdt), backend=backend)
        _same(q, jq, backend)
        _same(s, js, backend)


COLSCALE_SHAPES = [(1, 8, 4), (5, 40, 24), (17, 130, 70), (260, 64, 33)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "dgrad"])
@pytest.mark.parametrize("B,K,M", COLSCALE_SHAPES)
def test_colscale_matmul_matches_jax(B, K, M, transpose, dt):
    """y = (row ⊗ col) * (x_q . w_q[ᵀ]): w_q (K, M), or (M, K) read along
    its second dim (the dgrad of the column-wise variants)."""
    rng = np.random.default_rng(B * 10000 + K * 100 + M + transpose)
    x_q = rng.integers(-127, 128, size=(B, K), dtype=np.int8)
    w_q = rng.integers(-127, 128, size=(M, K) if transpose else (K, M), dtype=np.int8)
    row = rng.uniform(1e-5, 1e-3, size=(B, 1)).astype(np.float32)
    col = rng.uniform(1e-2, 3.0, size=(1, M)).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    fn = TOPS.int8_matmul_dequant_t if transpose else TOPS.int8_matmul_dequant
    y = fn(torch.from_numpy(x_q), torch.from_numpy(w_q), torch.from_numpy(row),
           col_scale=torch.from_numpy(col), out_dtype=tdt)
    assert y.dtype == tdt and y.shape == (B, M)
    for backend in JAX_BACKENDS:
        jy = JOPS.int8_matmul_dequant(jnp.asarray(x_q), jnp.asarray(w_q), jnp.asarray(row),
                                      col_scale=jnp.asarray(col), transpose_w=transpose,
                                      out_dtype=jdt, backend=backend)
        _same(y, jy, backend)


def test_colscale_wrappers_check_and_count_no_cpu_launch():
    TOPS.reset_launch_counts()
    x_q = torch.zeros(4, 8, dtype=torch.int8)
    w_q = torch.ones(8, 3, dtype=torch.int8)
    with pytest.raises(ValueError):
        TOPS.int8_matmul_dequant(x_q, w_q, torch.ones(4, 1), col_scale=torch.ones(1, 4))
    with pytest.raises(TypeError):
        TOPS.int8_matmul_dequant_t(x_q, w_q.t().contiguous(), torch.ones(4, 1),
                                   col_scale=torch.ones(1, 3, dtype=torch.float64))
    TOPS.int8_matmul_dequant(x_q, w_q, torch.ones(4, 1), col_scale=torch.ones(1, 3))
    TOPS.int8_matmul_dequant_t(x_q, w_q.t().contiguous(), torch.ones(4, 1),
                               col_scale=torch.ones(1, 3))
    TOPS.col_quantize(torch.ones(8, 3))
    counts = TOPS.launch_counts()
    assert set(counts.values()) == {0}
    assert {"col_quantize", "int8_matmul_dequant_colscale",
            "int8_matmul_dequant_colscale_t"} <= set(counts)


# ---------------------------------------------------------------------------
# the three new SwitchBack variants
# ---------------------------------------------------------------------------

def _activations(rng, B, K):
    x = _bf16_values(rng.standard_normal((B, K)).astype(np.float32) * 3)
    ties = (np.arange(K, dtype=np.float32) % 8) - 3.5
    ties[0] = 127.0                              # scale 1: every .5 a tie
    x[1] = ties
    x[2] = 0.0                                   # all-zero row
    return x


def _variant_case(variant, N, M, rows=12):
    rng = np.random.default_rng(N * 100 + M + len(variant))
    x = _activations(rng, rows, N)
    w = _weight(rng, N, M)
    g = _bf16_values(rng.standard_normal((rows, M)).astype(np.float32))
    g[4] = 0.0
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = TSB.switchback_linear(tx, tw, variant=variant, compute_dtype=torch.bfloat16)
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(g).to(torch.bfloat16))
    return (x, w, g), (y.detach(), dx, dw)


@pytest.mark.parametrize("variant", NEW_VARIANTS)
@pytest.mark.parametrize("N,M", [(40, 48), (24, 2304)], ids=["fused_widths", "wide_out"])
def test_variant_grads_match_jax(variant, N, M):
    """y, Ẋ (bf16) and Ẇ (f32) of the port's variant against ``jax.vjp`` of
    the JAX package's: bit for bit against its Pallas kernel path
    (interpreted), within Y_TOL / DW_TOL against its XLA path. M = 2304 >
    2048 sends switchback_m's dgrad through row_quantize and the
    transposed matmul."""
    (x, w, g), (y, dx, dw) = _variant_case(variant, N, M)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    for backend in JAX_BACKENDS:
        jy, vjp = jax.vjp(lambda a, b: JSB.switchback_linear(a, b, variant=variant,
                                                             backend=backend),
                          jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(g, jnp.bfloat16))
        if backend == "pallas_interpret":
            _same(y, jy, f"{variant} y")
            _same(dx, jdx, f"{variant} dx")
            _same(dw, jdw, f"{variant} dw")
        else:
            assert _rel(y, jy) <= Y_TOL["bf16"], (variant, "y", _rel(y, jy))
            assert _rel(dx, jdx) <= Y_TOL["bf16"], (variant, "dx", _rel(dx, jdx))
            assert _rel(dw, jdw) <= DW_TOL, (variant, "dw", _rel(dw, jdw))


@pytest.mark.parametrize("variant", NEW_VARIANTS)
def test_variant_f32_compute_matches_jax(variant):
    """The same at f32 compute (y and Ẋ in f32), against the Pallas path
    bit for bit and the XLA path within one f32 ulp of max|y|."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((9, 40)).astype(np.float32)
    w = rng.standard_normal((40, 24)).astype(np.float32) / 6
    g = rng.standard_normal((9, 24)).astype(np.float32)
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = TSB.switchback_linear(tx, tw, variant=variant, compute_dtype=torch.float32)
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(g))
    for backend in JAX_BACKENDS:
        jy, vjp = jax.vjp(lambda a, b: JSB.switchback_linear(a, b, variant=variant,
                                                             backend=backend),
                          jnp.asarray(x), jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(g))
        if backend == "pallas_interpret":
            _same(y.detach(), jy)
            _same(dx, jdx)
        else:
            assert _rel(y, jy) <= Y_TOL["f32"] and _rel(dx, jdx) <= Y_TOL["f32"]
        assert _rel(dw, jdw) <= DW_TOL


def test_switchback_m_saves_int8_residuals():
    """Alg. 3 keeps only the int8 X and its state (and the int8 W): no
    floating-point activation is saved for the backward."""
    x = torch.randn(6, 16, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(16, 8, requires_grad=True)
    y = TSB.SwitchBackMatmul.apply(x, w, torch.bfloat16, "switchback_m")
    saved = y.grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.int8, torch.float32, torch.int8, torch.float32]
    assert [tuple(t.shape) for t in saved] == [(6, 16), (6, 1), (16, 8), (1, 1)]


@pytest.mark.parametrize("R,n,m", [(12, 5, 3), (37, 20, 9), (130, 24, 17)])
def test_llm_int8_wgrad_is_exact(R, n, m):
    """The int8 product of LLM.int8's Ẇ is the exact int32 sum (against
    numpy in int64), and Ẇ equals the JAX package's ``_wgrad_int8`` bit
    for bit."""
    rng = np.random.default_rng(R + n + m)
    a = rng.integers(-127, 128, size=(R, n), dtype=np.int8)
    b = rng.integers(-127, 128, size=(R, m), dtype=np.int8)
    acc = TSB._int8_tn(torch.from_numpy(a), torch.from_numpy(b))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), a.astype(np.int64).T @ b.astype(np.int64))
    x = _bf16_values(rng.standard_normal((R, n)).astype(np.float32))
    g = _bf16_values(rng.standard_normal((R, m)).astype(np.float32))
    g[:, 0] = 0.0
    dw = TSB.wgrad_int8(torch.from_numpy(x).to(torch.bfloat16),
                        torch.from_numpy(g).to(torch.bfloat16))
    jdw = JSB._wgrad_int8(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16))
    assert dw.dtype == torch.float32
    _same(dw, jdw)


# ---------------------------------------------------------------------------
# flash attention at CLIP's attention form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,H,hd,causal", [(9, 4, 80, False), (13, 2, 64, True)],
                         ids=["vision_hd80_full", "text_hd64_causal"])
def test_flash_attention_at_clip_form_matches_jax(S, H, hd, causal):
    """MHA (KV heads = heads), no RoPE: the vision tower's non-causal hd 80
    and the text tower's causal hd 64, forward and gradients, bf16."""
    rng = np.random.default_rng(S * H + hd)
    q, k, v, do = (_bf16_values(rng.standard_normal((2, S, H, hd)).astype(np.float32))
                   for _ in range(4))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v))
    o = FA.flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do).to(torch.bfloat16))
    jo, vjp = jax.vjp(lambda a, b, c: JFA.flash_attention(a, b, c, causal=causal,
                                                          backend="pallas_interpret"),
                      *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    assert _rel(o, jo) <= 2.0 ** -7
    for got, want in zip(grads, vjp(jnp.asarray(do, jnp.bfloat16))):
        assert _rel(got, want) <= 2.0 ** -7
