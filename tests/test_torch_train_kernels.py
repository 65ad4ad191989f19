"""The training slice's kernel modules against the JAX package's, on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions; they
are held against the JAX package's Pallas kernels in interpret mode and
its XLA reference on the same inputs, made from a seeded numpy generator:

* the int8 dgrad pair (``fused_switchback_dgrad`` and the ``transpose_w``
  form of ``int8_matmul_dequant``): bit for bit, ragged edges, half-way
  ties and an all-zero row included;
* ``flash_bwd_dq`` / ``flash_bwd_dkv``: dq, dk, dv within 2e-6 of max|grad|
  (measured up to 6.3e-7): the plain version takes one full
  softmax-weighted sum where the Pallas kernels sum key tile by key tile,
  and it scales q before the product as the forward does where the TPU
  backward scales after it (exact at hd 64, one ulp apart at hd 40);
* the SwitchBack autograd function's Ẋ (bit for bit: int8 arithmetic, the
  same roundings) and Ẇ (f32 within 1e-6 of max|Ẇ|: the same bf16 products,
  summed in another order; measured 0) against ``jax.vjp`` of
  ``repro.core.switchback.switchback_linear``, on the fused dgrad and on
  the two-step dgrad past 2048;
* Ẇ reaches the f32 master weight unrounded: a check that fails if it
  were rounded through bf16 on the way.

The CUDA kernels run only on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold them against these plain versions there.
"""
from __future__ import annotations

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import switchback as JSB
from repro.core.precision import QuantPolicy as JPolicy
from repro.core.precision import quant_linear as jquant_linear
from repro.kernels.flash_attention import ops as JFA
from repro.kernels.flash_attention import ref as JREF
from repro.kernels.switchback import ops as JOPS
from repro_torch.core import switchback as TSB
from repro_torch.core.precision import QuantPolicy, quant_linear
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention import ref as FREF
from repro_torch.kernels.switchback import ops as TOPS

JK = importlib.import_module("repro.kernels.flash_attention.flash_attention")

torch.set_num_threads(1)

JAX_BACKENDS = ("xla", "pallas_interpret")
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}
BWD_TOL = 2e-6
DW_TOL = 1e-6


def _bf16_values(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _activations(rng, B, K):
    x = _bf16_values(rng.standard_normal((B, K)).astype(np.float32) * 3)
    if B >= 3:
        ties = (np.arange(K, dtype=np.float32) % 8) - 3.5
        ties[0] = 127.0                              # scale 1: every .5 a tie
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


def _rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


# ---------------------------------------------------------------------------
# the int8 dgrad pair
# ---------------------------------------------------------------------------

DGRAD_SHAPES = [(1, 8, 4), (5, 40, 24), (17, 130, 70), (260, 64, 33)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("B,M,N", DGRAD_SHAPES)
def test_fused_switchback_dgrad_matches_jax(B, M, N, dt):
    """g (B, M) against the forward's w_q (N, M), contracted over M."""
    rng = np.random.default_rng(B * 10000 + M * 100 + N)
    g = _activations(rng, B, M)
    w_q = rng.integers(-127, 128, size=(N, M), dtype=np.int8)
    s_w = np.array([[rng.uniform(0.1, 3.0)]], np.float32)
    jdt, tdt = DTYPES[dt]
    dx = TOPS.fused_switchback_dgrad(torch.from_numpy(g).to(tdt), torch.from_numpy(w_q),
                                     torch.from_numpy(s_w))
    assert dx.dtype == tdt and dx.shape == (B, N)
    for backend in JAX_BACKENDS:
        jdx = JOPS.fused_switchback_dgrad(jnp.asarray(g).astype(jdt), jnp.asarray(w_q),
                                          jnp.asarray(s_w), out_dtype=jdt, backend=backend)
        _same(dx, jdx)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("B,K,M", DGRAD_SHAPES)
def test_int8_matmul_dequant_t_matches_jax(B, K, M, dt):
    """x_q (B, K) against w_q (M, K), contracted over w_q's dim 1."""
    rng = np.random.default_rng(B * 10000 + K * 100 + M + 3)
    x_q = rng.integers(-127, 128, size=(B, K), dtype=np.int8)
    w_q = rng.integers(-127, 128, size=(M, K), dtype=np.int8)
    row_scale = rng.uniform(1e-5, 1e-3, size=(B, 1)).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    y = TOPS.int8_matmul_dequant_t(torch.from_numpy(x_q), torch.from_numpy(w_q),
                                   torch.from_numpy(row_scale), out_dtype=tdt)
    assert y.dtype == tdt and y.shape == (B, M)
    for backend in JAX_BACKENDS:
        jy = JOPS.int8_matmul_dequant(jnp.asarray(x_q), jnp.asarray(w_q),
                                      jnp.asarray(row_scale), transpose_w=True,
                                      out_dtype=jdt, backend=backend)
        _same(y, jy)


def test_dgrad_wrappers_reject_bad_inputs_and_count_no_cpu_launch():
    TOPS.reset_launch_counts()
    g = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        TOPS.fused_switchback_dgrad(g, torch.zeros(3, 9, dtype=torch.int8), torch.ones(1, 1))
    with pytest.raises(ValueError):
        TOPS.int8_matmul_dequant_t(torch.zeros(4, 8, dtype=torch.int8),
                                   torch.zeros(3, 9, dtype=torch.int8), torch.ones(4, 1))
    w_q = torch.ones(3, 8, dtype=torch.int8)
    TOPS.fused_switchback_dgrad(g, w_q, torch.ones(1, 1))
    TOPS.int8_matmul_dequant_t(torch.zeros(4, 8, dtype=torch.int8), w_q, torch.ones(4, 1))
    assert set(TOPS.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# the flash backward pair
# ---------------------------------------------------------------------------

def _kl(x):
    """(B, S, H, hd) <-> (B, H, S, hd)."""
    return jnp.transpose(x, (0, 2, 1, 3))


def _jax_bwd(q, k, v, o, do, lse, di, *, causal, kv_valid, backend):
    """(dq, dk, dv) in the model layout, f32, as the JAX ops' ``_bwd_impl``
    calls its kernels (padding to the blocks, the static kv_valid) or its
    XLA reference (which takes o and forms di itself)."""
    Sq, Sk, hd = q.shape[1], k.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(hd)
    qk, kk, vk, dok = map(_kl, (q, k, v, do))
    if backend == "xla":
        dq, dk, dv = JREF.mha_bwd(qk, kk, vk, _kl(o), lse, dok, causal=causal,
                                  kv_valid=kv_valid, scale=scale)
        return _kl(dq), _kl(dk), _kl(dv)
    bq, bk = JFA.choose_attn_blocks(Sq, Sk)
    pad = JFA._pad_seq
    args = (pad(qk, 2, bq), pad(kk, 2, bk), pad(vk, 2, bk), pad(dok, 2, bq),
            pad(lse, 2, bq), pad(di, 2, bq))
    kw = dict(causal=causal, kv_valid=kv_valid, scale=scale, block_q=bq, block_k=bk,
              interpret=True)
    dq = JK.flash_bwd_dq(*args, **kw)[:, :, :Sq]
    dk, dv = JK.flash_bwd_dkv(*args, **kw)
    return _kl(dq), _kl(dk[:, :, :Sk]), _kl(dv[:, :, :Sk])


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("B,S,Sk,H,KV,hd,kv_valid,causal", [
    (2, 16, 16, 4, 2, 64, 16, True),
    (2, 16, 16, 4, 2, 64, 16, False),
    (1, 24, 40, 6, 2, 40, 33, False),
    (2, 20, 20, 3, 1, 40, 20, True),
])
def test_flash_bwd_matches_jax(B, S, Sk, H, KV, hd, kv_valid, causal, dt):
    """The plain dq/dk/dv against the Pallas backward kernels (interpret)
    and the XLA reference, from the same (q, k, v, do) and the forward's
    lse: GQA, causal and full, keys masked past kv_valid < Sk."""
    rng = np.random.default_rng(B * 1000 + S * 10 + hd)
    q, do = (rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, KV, hd)).astype(np.float32) for _ in range(2))
    jdt, tdt = DTYPES[dt]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    o, lse = FA.flash_fwd_lse(tq, tk, tv, causal=causal, kv_valid=kv_valid)
    di = FREF.attention_di(o, tdo)
    dq = FA.flash_bwd_dq(tq, tk, tv, tdo, lse, di, causal=causal, kv_valid=kv_valid)
    dk, dv = FA.flash_bwd_dkv(tq, tk, tv, tdo, lse, di, causal=causal, kv_valid=kv_valid)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    assert dk.shape == dv.shape == (B, Sk, KV, hd)
    assert float(dk[:, kv_valid:].abs().sum()) == 0.0 == float(dv[:, kv_valid:].abs().sum())
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    for backend in JAX_BACKENDS:
        want = _jax_bwd(jq, jk, jv, jnp.asarray(o.float().numpy()).astype(jdt), jdo,
                        jnp.asarray(lse.numpy()), jnp.asarray(di.numpy()),
                        causal=causal, kv_valid=kv_valid, backend=backend)
        for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            assert _rel(got, w) <= BWD_TOL, (backend, name, _rel(got, w))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grads_match_jax(causal):
    """The differentiable ``flash_attention`` (forward, di, both backward
    kernels, one cast per gradient) against ``jax.vjp`` of the JAX
    package's ``flash_attention`` on its Pallas backend, bf16."""
    rng = np.random.default_rng(11)
    B, S, H, KV, hd = 2, 24, 6, 2, 64
    q, do = (_bf16_values(rng.standard_normal((B, S, H, hd)).astype(np.float32)) for _ in range(2))
    k, v = (_bf16_values(rng.standard_normal((B, S, KV, hd)).astype(np.float32)) for _ in range(2))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v))
    o = FA.flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do).to(torch.bfloat16))
    jo, vjp = jax.vjp(lambda a, b, c: JFA.flash_attention(a, b, c, causal=causal,
                                                          backend="pallas_interpret"),
                      *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    assert _rel(o.detach(), jo) <= 2.0 ** -7
    for got, want in zip(grads, vjp(jnp.asarray(do, jnp.bfloat16))):
        assert got.dtype == torch.bfloat16
        assert _rel(got, want) <= 2.0 ** -7           # one bf16 ulp of max|grad|


# ---------------------------------------------------------------------------
# the SwitchBack autograd function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [48, 2304], ids=["fused_dgrad", "two_step_dgrad"])
def test_switchback_grads_match_jax(M):
    """Ẋ and Ẇ of the SwitchBack linear against ``jax.vjp`` of the JAX
    package's (its XLA and Pallas paths), x bf16, the master weight in f32
    holding bf16 values (what quant_linear hands the layer). M is the
    layer's output width, the dgrad's contraction: 48 takes the fused
    dgrad kernel, 2304 > 2048 row-quantize + the transposed int8 matmul."""
    rng = np.random.default_rng(M)
    N = 40
    x = _activations(rng, 12, N)
    w = _bf16_values(rng.standard_normal((N, M)).astype(np.float32) / np.sqrt(N))
    g = _bf16_values(rng.standard_normal((12, M)).astype(np.float32))
    g[4] = 0.0
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = TSB.switchback_linear(tx, tw, compute_dtype=torch.bfloat16)
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(g).to(torch.bfloat16))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    for backend in JAX_BACKENDS:
        jy, vjp = jax.vjp(lambda a, b: JSB.switchback_linear(a, b, backend=backend),
                          jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(g, jnp.bfloat16))
        if backend == "xla":
            _same(y.detach(), jy)
        else:
            # the interpreted Pallas forward runs under jit, where XLA's
            # rounding of the dequantize epilogue lands a handful of
            # outputs one bf16 ulp apart (4 of 27,648 here, 9.8e-4 of
            # max|y|); the eager XLA path and the port's kernels agree
            assert _rel(y.detach(), jy) <= 2.0 ** -7
        _same(dx, jdx)
        assert np.asarray(jdw).dtype == np.float32
        assert _rel(dw, jdw) <= DW_TOL, (backend, _rel(dw, jdw))


def _dw_case(rows=64, n=24, m=16):
    """Inputs whose f32 Ẇ = xᵀ g is far from bf16-representable."""
    rng = np.random.default_rng(5)
    x = _bf16_values(rng.standard_normal((rows, n)).astype(np.float32))
    w = _bf16_values(rng.standard_normal((n, m)).astype(np.float32) * 0.1)
    g = _bf16_values(rng.standard_normal((rows, m)).astype(np.float32))
    exact = x.astype(np.float64).T @ g.astype(np.float64)
    return x, w, g, exact


@pytest.mark.parametrize("mode", ["int8_switchback", "bf16"])
def test_weight_grad_reaches_the_f32_master_unrounded(mode):
    """``quant_linear`` takes the f32 master weight and returns its gradient
    in f32 from the bf16 inputs' exact products: within 1e-6 of max|Ẇ| of
    the float64 sum. Rounded through bf16 on the way (torch casts a
    Function's gradient to its input's dtype, so a cast before the
    function would do it) it would be about 2^-9 off, and this fails."""
    x, w, g, exact = _dw_case()
    tw = torch.from_numpy(w).requires_grad_()
    y = quant_linear(torch.from_numpy(x).to(torch.bfloat16), tw, policy=QuantPolicy(mode))
    y.backward(torch.from_numpy(g).to(torch.bfloat16))
    dw = tw.grad.double().numpy()
    scale = np.abs(exact).max()
    rounded = torch.from_numpy(exact).float().bfloat16().double().numpy()
    assert tw.grad.dtype == torch.float32
    assert np.abs(dw - exact).max() / scale <= DW_TOL
    # the check can see the fault it guards against
    assert np.abs(rounded - exact).max() / scale > 100 * DW_TOL


def test_jax_model_path_rounds_dw_through_bf16():
    """Where the port departs from the JAX package on purpose. The JAX
    layers cast the master weight to bf16 (``use_weight``) before
    ``quant_linear`` widens it to f32 for the custom VJP, so jax.grad
    rounds Ẇ through bf16 on its way back to the f32 master (and in the
    ``bf16`` mode the dot's transpose returns a bf16 Ẇ). The port keeps Ẇ
    in f32, the paper's 16-bit inputs with an f32 weight gradient. Both
    sides hold the same bf16 products; they differ by that one rounding."""
    x, w, g, exact = _dw_case()
    for mode in ("int8_switchback", "bf16"):
        def loss(w32):
            y = jquant_linear(jnp.asarray(x, jnp.bfloat16), w32.astype(jnp.bfloat16),
                              policy=JPolicy(mode))
            return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g))
        jdw = np.asarray(jax.grad(loss)(jnp.asarray(w)), np.float64)
        as_bf16 = torch.from_numpy(jdw).float().bfloat16().double().numpy()
        np.testing.assert_array_equal(jdw, as_bf16)
        assert np.abs(jdw - exact).max() / np.abs(exact).max() > 100 * DW_TOL
