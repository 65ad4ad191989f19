"""The port's SSM blocks (``models/ssm/mamba.py``, ``models/ssm/rwkv6.py``)
and ``group_norm_heads`` against the JAX package's, on the CPU.

Inputs and layer parameters are drawn from seeded numpy and carried to
both packages (every leaf drawn, so the LoRAs, decays and biases that the
inits set to constants take part). The JAX side is jitted with XLA's excess
precision off, on its ``xla`` backend. Bit for bit where the arithmetic is
exact: the causal conv on bf16 inputs (bf16 products are exact in f32, the
taps summed in one order). Elsewhere within a stated tolerance, relative to
the largest magnitude: XLA's ``exp``, ``log1p``, ``tanh`` and its f32 sums
(``cumsum``, ``einsum``, the f32 products) round otherwise than torch's by
an ulp or so, F32_TOL; through bf16 outputs such an ulp can take the other
side of a rounding (BF16_TOL: a bf16 ulp of the largest value), and under
``int8_switchback`` a row's quantization step (INT8_TOL).

* the configs and the parameter specs: field for field, leaf for leaf;
* ``_conv1d_causal``, ``selective_scan`` (with and without h0),
  ``mamba_block`` (with and without a state, and its new state);
* ``rwkv6_scan``, ``rwkv6_chunked`` (against JAX's chunked form and against
  the port's scan), the three branches of ``rwkv6_block`` (one token with a
  state, 64 tokens with none: the chunked form, 16 tokens with a state: the
  scan and the fold) and its new state, ``rwkv_channel_mix``;
* each block under ``bf16`` with f32 compute, ``bf16`` and
  ``int8_switchback``;
* ``group_norm_heads`` and the population variance it takes (an unbiased
  variance reads 1/(n - 1) apart); the softplus JAX's form, bit for bit on
  10 <= x < 20 with its gradient (``F.softplus``'s gradient differs there).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.core.precision import QuantPolicy as JPolicy
from repro.models import common as JC
from repro.models import transformer as JTF
from repro.models.ssm import mamba as JM
from repro.models.ssm import rwkv6 as JR
from repro_torch.configs import ALL_ARCHS, get_config, get_reduced_config
from repro_torch.core.precision import QuantPolicy
from repro_torch.models import common as TC
from repro_torch.models import transformer as TTF
from repro_torch.models.params import from_numpy_tree, tree_paths
from repro_torch.models.ssm import mamba as TM
from repro_torch.models.ssm import rwkv6 as TR

torch.set_num_threads(1)

ARCHS = ("rwkv6-1.6b", "jamba-v0.1-52b")
OPTS = {"xla_allow_excess_precision": False}
F32_TOL = 2e-6             # f32 sums and transcendental functions in another order / form
BF16_TOL = 2.0 ** -7       # one bf16 ulp of the largest value
INT8_TOL = 2.0 ** -5       # a row's quantization step moved by an ulp upstream
# the three policies: (name, port policy, JAX policy, input dtypes)
POLICIES = {
    "bf16_f32": (QuantPolicy("bf16", compute_dtype=torch.float32),
                 JPolicy("bf16", compute_dtype=jnp.float32), torch.float32, F32_TOL),
    "bf16": (QuantPolicy("bf16"), JPolicy("bf16"), torch.bfloat16, BF16_TOL),
    "int8_switchback": (QuantPolicy("int8_switchback"), JPolicy("int8_switchback"),
                        torch.bfloat16, INT8_TOL),
}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=OPTS)(*args)


def _j(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(
        {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[t.dtype])


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want) -> float:
    got, want = np.asarray(_np(got), np.float64), np.asarray(_np(want), np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _draw(rng, shape, scale=1.0, loc=0.0):
    return (loc + scale * rng.standard_normal(shape)).astype(np.float32)


# leaf -> (loc, scale) where a unit normal would not do (weights take 1/sqrt(fan_in));
# w0 about -3 (the init's -6 plus a trained drift): the chunked form's
# exp(-cumsum log w) overflows in both packages once a chunk's summed decay
# passes ~88
_LEAF_DRAWS = {"w0": (-3.0, 0.5), "u": (0.0, 0.5), "ln_x": (1.0, 0.1), "D": (1.0, 0.1),
               "A_log": (0.0, 0.5), "dt_bias": (-2.0, 0.5), "conv_w": (0.0, 0.3),
               "conv_b": (0.0, 0.1)}


def _layer_params(specs, seed):
    """Every leaf of one layer's spec dict drawn from numpy: weights at
    1/sqrt(fan_in), the mixes' mu in [0, 1), the LoRA-B and decay leaves
    nonzero."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(specs):
        shape = specs[name].shape
        if name.startswith("mu_"):
            out[name] = rng.random(shape).astype(np.float32)
        elif name in _LEAF_DRAWS:
            loc, scale = _LEAF_DRAWS[name]
            out[name] = _draw(rng, shape, scale, loc)
        else:
            out[name] = _draw(rng, shape, 1.0 / np.sqrt(shape[0]))
    return out


def _both(params):
    return jax.tree.map(jnp.asarray, params), from_numpy_tree(params, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_specs_match_jax(arch):
    assert arch in ALL_ARCHS
    for mine, theirs in ((get_config(arch), jax_config(arch)),
                         (get_reduced_config(arch), jax_reduced(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert [mine.layer_kind(i) for i in range(mine.n_layers)] == \
            [theirs.layer_kind(i) for i in range(theirs.n_layers)]
        assert [mine.layer_is_moe(i) for i in range(mine.n_layers)] == \
            [theirs.layer_is_moe(i) for i in range(theirs.n_layers)]
        assert mine.supports_long_context and theirs.supports_long_context
        want = {jax.tree_util.keystr(k): (s.shape, s.logical, s.init, s.scale)
                for k, s in jax.tree_util.tree_leaves_with_path(
                    JTF.param_specs(theirs), is_leaf=lambda s: hasattr(s, "logical"))}
        got = {p: (s.shape, s.logical, s.init, s.scale)
               for p, s in tree_paths(TTF.param_specs(mine))}
        assert got == want


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix", [False, True], ids=["zeros", "prefix"])
def test_conv1d_causal_matches_jax(prefix):
    rng = np.random.default_rng(1)
    x, k, b = _draw(rng, (2, 16, 32)), _draw(rng, (4, 32)), _draw(rng, (32,))
    pre = _draw(rng, (2, 3, 32)) if prefix else None
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        tx = torch.from_numpy(x).to(dt)
        tpre = torch.from_numpy(pre).to(dt) if prefix else None
        got = TM._conv1d_causal(tx, torch.from_numpy(k), torch.from_numpy(b), tpre)
        want = _jit(lambda a, kk, bb, p: JM._conv1d_causal(a, kk, bb, p), _j(tx),
                    jnp.asarray(k), jnp.asarray(b), None if tpre is None else _j(tpre))
        assert got.dtype == dt
        if dt == torch.bfloat16:      # bf16 products exact in f32, one order of the taps
            np.testing.assert_array_equal(_np(got), _np(want))
        else:
            assert _rel(got, want) <= F32_TOL


@pytest.mark.parametrize("h0", [False, True], ids=["zeros", "h0"])
def test_selective_scan_matches_jax(h0):
    rng = np.random.default_rng(2)
    B, S, d, N = 2, 24, 32, 8
    u, C, D = _draw(rng, (B, S, d)), _draw(rng, (B, S, N)), _draw(rng, (d,))
    delta = np.abs(_draw(rng, (B, S, d), 0.2))
    A = -np.exp(_draw(rng, (d, N), 0.5))
    Bm = _draw(rng, (B, S, N))
    h = _draw(rng, (B, d, N)) if h0 else None
    args = [u, delta, A, Bm, C, D, h]
    ty, th = TM.selective_scan(*(None if a is None else torch.from_numpy(a) for a in args))
    jy, jh = _jit(lambda *a: JM.selective_scan(*a), *(None if a is None else jnp.asarray(a)
                                                       for a in args))
    assert th.dtype == torch.float32 and th.shape == (B, d, N)
    assert _rel(ty, jy) <= F32_TOL and _rel(th, jh) <= F32_TOL


def _jamba_layer(seed=3):
    cfg = get_reduced_config("jamba-v0.1-52b")
    return cfg, jax_reduced("jamba-v0.1-52b"), _layer_params(TTF._mamba_specs(cfg), seed)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
def test_mamba_block_matches_jax(policy, with_state):
    cfg, jcfg, params = _jamba_layer()
    pol, jpol, dt, tol = POLICIES[policy]
    jp, tp = _both(params)
    rng = np.random.default_rng(4)
    B, S, d_in = 2, 12, cfg.mamba.expand * cfg.d_model
    x = torch.from_numpy(_draw(rng, (B, S, cfg.d_model))).to(dt)
    state = jstate = None
    if with_state:
        conv = torch.from_numpy(_draw(rng, (B, cfg.mamba.d_conv - 1, d_in))).to(dt)
        h = torch.from_numpy(_draw(rng, (B, d_in, cfg.mamba.d_state), 0.5))
        state, jstate = TM.MambaState(conv, h), JM.MambaState(_j(conv), _j(h))
    out, new = TM.mamba_block(x, tp, cfg, pol, state=state)
    jout, jnew = _jit(lambda xx, pp, st: JM.mamba_block(xx, pp, jcfg, jpol, state=st),
                      _j(x), jp, jstate)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert _rel(out, jout) <= tol, _rel(out, jout)
    assert new.conv.dtype == dt and new.h.dtype == torch.float32
    # the conv window is the raw inputs (w_in's output): the projection's bits
    assert _rel(new.conv, jnew.conv) <= tol and _rel(new.h, jnew.h) <= tol


def _softplus_inputs():
    return np.linspace(-30.0, 30.0, 60001).astype(np.float32)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_softplus_is_jax_logaddexp_form():
    """``jax.nn.softplus`` is logaddexp(x, 0), max(x, 0) + log1p(exp(-|x|)),
    with JAX's gradient g · exp(x - out). On 10 <= x < 20 the port's value
    and gradient are JAX's bit for bit, where ``F.softplus``'s
    log1p(exp(x)) and its z / (z + 1) gradient read up to 8 ulps off;
    everywhere the port is within 3 ulps (value) and 8 (gradient) of JAX
    (XLA's exp and log1p are not torch's)."""
    xs = _softplus_inputs()
    jv = np.asarray(_jit(jax.nn.softplus, jnp.asarray(xs)))
    jg = np.asarray(_jit(jax.grad(lambda a: jax.nn.softplus(a).sum()), jnp.asarray(xs)))
    t = torch.from_numpy(xs).requires_grad_(True)
    tv = TM.softplus(t)
    tv.sum().backward()
    tf = torch.from_numpy(xs).requires_grad_(True)
    torch.nn.functional.softplus(tf).sum().backward()
    tv, tg, fg = tv.detach().numpy(), t.grad.numpy(), tf.grad.numpy()
    mid = (xs >= 10) & (xs < 20)
    np.testing.assert_array_equal(tv[mid], jv[mid])
    np.testing.assert_array_equal(tg[mid], jg[mid])
    assert (fg[mid] != jg[mid]).sum() > mid.sum() // 2          # the torch form's gradient differs
    assert _ulps(tv, jv).max() <= 3 and _ulps(tg, jg).max() <= 8
    assert torch.isnan(TM.softplus(torch.tensor([float("nan")]))).all()


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

def _rkvwu(B, S, H, hd, seed=5):
    rng = np.random.default_rng(seed)
    r, k, v = (_draw(rng, (B, S, H, hd)) for _ in range(3))
    w = np.exp(-np.exp(_draw(rng, (B, S, H, hd), 1.0, -2.0))).astype(np.float32)
    u = _draw(rng, (H, hd), 0.5)
    return r, k, v, w, u


def test_rwkv6_scan_matches_jax():
    args = _rkvwu(2, 40, 3, 16)
    to, ts = TR.rwkv6_scan(*map(torch.from_numpy, args))
    jo, js = _jit(lambda *a: JR.rwkv6_scan(*a), *map(jnp.asarray, args))
    assert to.dtype == ts.dtype == torch.float32
    assert _rel(to, jo) <= F32_TOL and _rel(ts, js) <= F32_TOL


def test_rwkv6_chunked_matches_jax_and_the_scan():
    """Against JAX's chunked form (two chunks of 64), and the port's chunked
    form against its own scan (the chunk's exp(±cumsum log w) factors round
    otherwise: CHUNK_VS_SCAN_TOL)."""
    args = _rkvwu(2, 128, 2, 16, seed=6)
    to, ts = TR.rwkv6_chunked(*map(torch.from_numpy, args))
    jo, js = _jit(lambda *a: JR.rwkv6_chunked(*a), *map(jnp.asarray, args))
    assert _rel(to, jo) <= F32_TOL and _rel(ts, js) <= F32_TOL
    so, ss = TR.rwkv6_scan(*map(torch.from_numpy, args))
    assert _rel(to, so) <= 1e-4 and _rel(ts, ss) <= 1e-4


def _rwkv_layer(seed=7):
    cfg = get_reduced_config("rwkv6-1.6b")
    return cfg, jax_reduced("rwkv6-1.6b"), _layer_params(TTF._rwkv_specs(cfg), seed)


def _rwkv_state(cfg, B, dt, rng):
    H, hd, D = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim, cfg.d_model
    st = TR.RWKVState(torch.from_numpy(_draw(rng, (B, H, hd, hd), 0.5)),
                      torch.from_numpy(_draw(rng, (B, D))).to(dt),
                      torch.from_numpy(_draw(rng, (B, D))).to(dt))
    return st, JR.RWKVState(*(_j(t) for t in st))


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("branch", ["one_token", "chunked", "scan_fold", "scan"])
def test_rwkv6_block_matches_jax(policy, branch):
    """S = 1 with a state (the one-token update), S = 64 with none (the
    chunked form), S = 16 with a state (the scan and the fold of the
    initial state) and with none (the scan)."""
    cfg, jcfg, params = _rwkv_layer()
    pol, jpol, dt, tol = POLICIES[policy]
    jp, tp = _both(params)
    rng = np.random.default_rng(8)
    B = 2
    S = {"one_token": 1, "chunked": 64}.get(branch, 16)
    x = torch.from_numpy(_draw(rng, (B, S, cfg.d_model))).to(dt)
    state = jstate = None
    if branch in ("one_token", "scan_fold"):
        state, jstate = _rwkv_state(cfg, B, dt, rng)
    out, new = TR.rwkv6_block(x, tp, cfg, pol, state=state)
    jout, jnew = _jit(lambda xx, pp, st: JR.rwkv6_block(xx, pp, jcfg, jpol, state=st),
                      _j(x), jp, jstate)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert _rel(out, jout) <= tol, _rel(out, jout)
    assert new.wkv.dtype == torch.float32 and _rel(new.wkv, jnew.wkv) <= tol
    assert torch.equal(new.x_prev, x[:, -1])
    np.testing.assert_array_equal(_np(new.cm_x_prev), _np(jnew.cm_x_prev))


@pytest.mark.parametrize("policy", list(POLICIES))
def test_rwkv_channel_mix_matches_jax(policy):
    cfg, jcfg, params = _rwkv_layer(seed=9)
    pol, jpol, dt, tol = POLICIES[policy]
    jp, tp = _both(params)
    rng = np.random.default_rng(10)
    x = torch.from_numpy(_draw(rng, (2, 12, cfg.d_model))).to(dt)
    xp = torch.from_numpy(_draw(rng, (2, cfg.d_model))).to(dt)
    out, last = TR.rwkv_channel_mix(x, tp, cfg, pol, x_prev=xp)
    jout, jlast = _jit(lambda xx, pp, pr: JR.rwkv_channel_mix(xx, pp, jcfg, jpol, x_prev=pr),
                       _j(x), jp, _j(xp))
    assert out.dtype == x.dtype and _rel(out, jout) <= tol, _rel(out, jout)
    assert torch.equal(last, x[:, -1])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_group_norm_heads_matches_jax(dt):
    """Within F32_TOL in f32 (the mean's and the variance's sums in another
    order) and bit for bit through bf16; an unbiased variance would read
    about 1/(2 (hd - 1)) apart, far outside."""
    rng = np.random.default_rng(11)
    H, hd = 4, 16
    x = torch.from_numpy(_draw(rng, (3, 5, H * hd), 2.0, 0.5)).to(dt)
    g = torch.from_numpy(_draw(rng, (H * hd,), 0.1, 1.0))
    got = TC.group_norm_heads(x, g, H)
    want = _jit(lambda a, b: JC.group_norm_heads(a, b, H), _j(x), jnp.asarray(g))
    assert got.dtype == dt
    if dt == torch.bfloat16:
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        assert _rel(got, want) <= F32_TOL
    xf = x.float().reshape(3, 5, H, hd)
    unbiased = ((xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(torch.var(xf, -1, keepdim=True)
                                                               + 64e-5)).reshape(x.shape) * g
    assert _rel(unbiased, want) > 100 * F32_TOL
