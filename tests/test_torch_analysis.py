"""The port's App. C variance analysis, the rest of ``core/quantization.py``
and the feature statistics against the JAX package's, on the CPU.

Exact where the arithmetic is exact: the int8 products of Eq. 3 and Eq. 4
sum int8 products exactly (int32 in JAX, float64 in the port) and round
the scale as the reference does, so they agree bit for bit; the simulated
fp8 product is held bit for bit at a contraction whose f32 sums are exact
(fp8 values of [-1, 1] carry products on a 2^-18 grid: 32 of them sum
below 2^5, within f32's 24 bits). The stochastic quantizer draws its
uniforms from a ``torch.Generator`` (threefry cannot be replayed), so it
is held to everything but the draw: given the reference's own uniforms its
codes are the reference's bit for bit, every code is floor(x·127/s) or one
more, and the mean code is unbiased within six standard errors. The
statistics (std, var, mean) sum in another order than XLA: within 1e-5
relative.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analysis as JAN
from repro.core import quantization as JQ
from repro.stability import feature_stats as JFS
from repro_torch.core import analysis as TAN
from repro_torch.core import quantization as TQ
from repro_torch.models import params as PRM
from repro_torch.stability import feature_stats as TFS

torch.set_num_threads(1)

STAT_TOL = 1e-5


def _int8_operands(rng, b=(3, 5), n=40, m=7):
    x = rng.standard_normal(b + (n,)).astype(np.float32) * 3
    w = rng.standard_normal((m, n)).astype(np.float32)
    return x, w


def test_eq3_rowwise_tensorwise_is_bitwise():
    rng = np.random.default_rng(0)
    x, w = _int8_operands(rng)
    jxq, jsx = JQ.quantize_rowwise(jnp.asarray(x))
    jwq, jsw = JQ.quantize_tensorwise(jnp.asarray(w))
    want = np.asarray(JQ.int8_matmul_dequant_rowwise_tensorwise(jxq, jwq, jsx, jsw))
    t = [torch.from_numpy(np.array(a)) for a in (jxq, jwq, jsx, jsw)]
    got = TQ.int8_matmul_dequant_rowwise_tensorwise(*t).numpy()
    np.testing.assert_array_equal(got, want)
    got16 = TQ.int8_matmul_dequant_rowwise_tensorwise(*t, out_dtype=torch.bfloat16)
    want16 = JQ.int8_matmul_dequant_rowwise_tensorwise(jxq, jwq, jsx, jsw, out_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(got16.float().numpy(), np.asarray(want16, np.float32))


def test_eq4_rowwise_rowwise_is_bitwise():
    rng = np.random.default_rng(1)
    x, w = _int8_operands(rng)
    jxq, jsx = JQ.quantize_rowwise(jnp.asarray(x))
    jwq, jsw = JQ.quantize_rowwise(jnp.asarray(w))             # (m, n), state (m, 1)
    want = np.asarray(JQ.int8_matmul_dequant_rowwise_rowwise(jxq, jwq, jsx, jsw))
    got = TQ.int8_matmul_dequant_rowwise_rowwise(
        *(torch.from_numpy(np.array(a)) for a in (jxq, jwq, jsx, jsw))).numpy()
    assert got.shape == (3, 5, 7)
    np.testing.assert_array_equal(got, want)


def test_eq3_through_the_kernel_wrappers_is_the_plain_function():
    """``analysis.eq3_product`` (the wrappers: on the CPU their plain
    versions) gives the quantizers' and Eq. 3's bits."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((33, 70)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((9, 70)).astype(np.float32))
    x_q, s_x, w_q, s_w, approx = TAN.eq3_product(x, w)
    qx, sx = TQ.quantize_rowwise(x)
    qw, sw = TQ.quantize_tensorwise(w)
    assert torch.equal(x_q, qx) and torch.equal(s_x, sx)
    assert torch.equal(w_q, qw) and torch.equal(s_w.reshape(()), sw)
    assert torch.equal(approx, TQ.int8_matmul_dequant_rowwise_tensorwise(qx, qw, sx, sw))


@pytest.mark.parametrize("fmt_x,fmt_w,row_w", [("e4m3", "e4m3", False), ("e4m3", "e5m2", True)])
def test_fp8_matmul_dequant_matches_jax(fmt_x, fmt_w, row_w):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 32)).astype(np.float32) * 4
    w = rng.standard_normal((5, 32)).astype(np.float32)
    jxq, jsx = JQ.quantize_rowwise_fp8(jnp.asarray(x), fmt_x)
    jwq, jsw = (JQ.quantize_rowwise_fp8 if row_w else JQ.quantize_tensorwise_fp8)(
        jnp.asarray(w), fmt_w)
    want = np.asarray(JQ.fp8_matmul_dequant(jxq, jwq, jsx, jsw))
    got = TQ.fp8_matmul_dequant(*(torch.from_numpy(np.array(a)) for a in (jxq, jwq, jsx, jsw)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_stochastic_codes_are_the_reference_formula():
    """Given the reference's own uniforms (its key's draw), the port's codes
    are the reference's bit for bit."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 48)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jq, js = JQ.quantize_rowwise_stochastic(jnp.asarray(x), key)
    u = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    got = TQ.stochastic_codes(torch.from_numpy(x), torch.from_numpy(np.asarray(js)),
                              torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq))


def test_stochastic_rounding_floor_or_ceil_and_unbiased():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    n = 400
    draws = [TQ.quantize_rowwise_stochastic(x, gen) for _ in range(n)]
    state = draws[0][1]
    assert all(torch.equal(s, state) for _, s in draws)
    assert torch.equal(state, TQ.quantize_rowwise(x)[1])
    scaled = x * TQ.div(127.0, state)
    floor = torch.floor(scaled)
    codes = torch.stack([q.float() for q, _ in draws])
    assert bool(((codes == floor) | (codes == floor + 1)).all())
    assert not torch.equal(codes[0], codes[1])              # the draws differ
    # E[code] = scaled; each draw a Bernoulli of variance <= 1/4
    err = (codes.mean(0) - scaled).abs().max()
    assert float(err) <= 6 * 0.5 / np.sqrt(n), float(err)


def test_predicted_variance_is_the_reference():
    for args in [(64, 1.0, 1.0, 0.01), (65536, 0.5, 2.0, 3e-3), (1280, 1.0, 1.0, 7.1e-3)]:
        assert TAN.predicted_quant_variance(*args) == JAN.predicted_quant_variance(*args)


def test_rowwise_noise_sigma_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((32, 200)).astype(np.float32) * 5
    got = float(TAN.rowwise_int8_noise_sigma(torch.from_numpy(x)))
    want = float(JAN.rowwise_int8_noise_sigma(jnp.asarray(x)))
    assert abs(got - want) <= STAT_TOL * want, (got, want)
    # uniform rounding noise, Δ/sqrt(12) with Δ = absmax / 127 of each row
    delta = np.abs(x).max(axis=1).mean() / 127
    assert 0.7 < got / (delta / np.sqrt(12)) < 1.3


def test_appendix_c_criteria_hold():
    """The reference's own criteria (tests/test_quantization.py): the
    measured variance within a factor 3 of the prediction at k = 64 and
    1,024, and growing more than 4x between them."""
    v_small, p_small = TAN.empirical_matmul_quant_error(torch.Generator().manual_seed(1),
                                                        b=64, k=64, m=64)
    v_large, p_large = TAN.empirical_matmul_quant_error(torch.Generator().manual_seed(2),
                                                        b=64, k=1024, m=64)
    assert v_large / v_small > 4
    assert 0.3 < v_small / p_small < 3.0
    assert 0.3 < v_large / p_large < 3.0


def test_block_feature_magnitude_matches_jax():
    rng = np.random.default_rng(7)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                    (torch.float16, jnp.float16)):
        x = rng.standard_normal((4, 9, 24)).astype(np.float32)
        want = float(JFS.block_feature_magnitude(jnp.asarray(x, jdt)))
        got = float(TFS.block_feature_magnitude(torch.from_numpy(x).to(dt)))
        assert abs(got - want) <= STAT_TOL * want, (dt, got, want)


def test_vit_block_stat_is_block_feature_magnitude():
    """vit_block's per-block stat is ``block_feature_magnitude`` of its
    output, bit for bit."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.precision import QuantPolicy
    from repro_torch.models import build, vit
    cfg = get_reduced_config("clip-vit-huge")
    params = PRM.init_params(build(cfg).param_specs, 0, device="cpu")
    lp = PRM.tree_map(lambda t: t[0], params["visual"]["blocks"])
    x = torch.randn(2, 5, cfg.vision_width, generator=torch.Generator().manual_seed(0))
    y, stat = vit.vit_block(x, lp, cfg.vision_heads, QuantPolicy("bf16", torch.float32),
                            collect_stats=True, impl="dense")
    assert torch.equal(stat, TFS.block_feature_magnitude(y))


def test_gradient_stats_match_jax():
    rng = np.random.default_rng(8)
    g = {"a": rng.standard_normal((5, 6)).astype(np.float32),
         "b": {"c": np.array([1.0, np.inf, -2.0, np.nan], np.float32)}}
    want = JFS.gradient_stats(jax.tree.map(jnp.asarray, g))
    got = TFS.gradient_stats(PRM.tree_map(torch.from_numpy, g))
    for path, leaf in (("a", lambda t: t["a"]), ("c", lambda t: t["b"]["c"])):
        w, t = leaf(want), leaf(got)
        assert int(t["nonfinite"]) == int(w["nonfinite"]), path
        for k in ("mean", "max"):
            np.testing.assert_allclose(float(t[k]), float(w[k]), rtol=STAT_TOL, err_msg=path)
