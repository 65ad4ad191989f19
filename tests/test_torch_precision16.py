"""The paper's remaining precisions against the JAX package's, on the CPU:
``fp16`` with loss scaling (the ``FP16`` policy, f16 compute, §2.1 and
§3.6) on the f16 forms of the flash kernels, and ``fp32`` with bf16 compute
(``QuantPolicy.from_train_config``'s) and with f32 compute.

The flash kernels' f16 forms: the plain versions (``ref.py``, f32
arithmetic, o rounded once to f16) against the JAX package's Pallas
kernels in interpret mode and its XLA reference, on f16 inputs. o within
2^-10 of max|o|, one f16 ulp at the largest value (measured up to 1.9e-4:
the online and the full softmax sum in another order, and round to f16 on
either side of a boundary now and then); lse within 5e-6 absolute
(measured 9.5e-7); dq, dk, dv within 2e-6 of max|grad| (measured 9.7e-7):
f16 values are exact in f32, so these are the f32 forms' tolerances.

The linear under ``FP16`` gives JAX's bits (eager on both sides): y, Ẋ and
Ẇ, the f32 Ẇ rounded through the f16 weight on its way to the master,
where an overflow shows as an Inf that the loss scaler skips. Under
``fp32`` the products are f32 GEMMs summed in another order (1e-6).

Whole steps, 3 of them, the reduced CLIP (batch 4) and smollm (4 x 16), the
port against the JAX train step jitted with XLA's excess precision off
(f16 needs it as bf16 does): the loss-scale sequence and the count of
skipped tensors equal step by step, every loss and grad norm as in
``tests/test_torch_clip.py`` and ``tests/test_torch_train.py`` (a NaN or
Inf grad norm on both sides where a tensor overflowed), and each leaf's
change over the steps (mean |diff| over the largest change JAX made).
The reference cannot run ``fp32`` with bf16 compute on scanned layers (the
scan's carry comes in as bf16 and leaves as f32, a TypeError); the port
always runs a Python loop, so it is held against JAX with
``scan_layers=False`` there (ROADMAP.md Queue 3).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.core import precision as JP
from repro.kernels.flash_attention import ops as JFA
from repro.models import build as jax_build
from repro.models import params as JPRM
from repro.models.params import init_params as jax_init_params
from repro.train import train_step as JTS
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import precision as TP
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention import ref as FREF
from repro_torch.models import build
from repro_torch.models import params as PRM
from repro_torch.models.params import from_numpy_tree
from repro_torch.train import init_train_state, make_train_setup, make_train_step

import test_torch_clip as TCLIP
from test_torch_flash_attention import FWD_SHAPES, _jax_fwd
from test_torch_train_kernels import _jax_bwd, _rel

torch.set_num_threads(1)

O_TOL = 2.0 ** -10
LSE_TOL = 5e-6
BWD_TOL = 2e-6
F32_TOL = 1e-6
XLA = {"xla_allow_excess_precision": False}
N_STEPS = 3
# (loss at the first step, later steps, grad norm, each leaf's change):
# CLIP's from tests/test_torch_clip.py (measured here up to 3.2e-4, 8.2e-5,
# 3.0e-4 and 1.7e-3), smollm's from tests/test_torch_train.py
STEP_TOL = {"clip": (2e-3, 3e-2, 3e-2, 5e-2), "smollm": (1e-3, 1e-3, 1e-2, 5e-2)}

FP16_POLICIES = (JP.FP16, TP.FP16)
FP32_POLICIES = {"bf16": (JP.QuantPolicy("fp32"), TP.QuantPolicy("fp32")),
                 "f32": (JP.QuantPolicy("fp32", compute_dtype=jnp.float32),
                         TP.QuantPolicy("fp32", compute_dtype=torch.float32))}


# ---------------------------------------------------------------------------
# the flash kernels' f16 forms (their plain versions here)
# ---------------------------------------------------------------------------

def _f16(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_f16_flash_fwd_and_bwd_match_jax(shape, causal):
    B, Sq, Sk, H, KV, hd, kv_valid = shape
    rng = np.random.default_rng(Sq * 100 + Sk + H + hd)
    q, k, v, do = _f16(rng, (B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd), (B, Sq, H, hd))
    tq, tk, tv, tdo = (torch.from_numpy(a).half() for a in (q, k, v, do))
    kw = dict(causal=causal, kv_valid=kv_valid)
    o, lse = FA.flash_fwd_lse(tq, tk, tv, **kw)
    assert o.dtype == torch.float16 and lse.dtype == torch.float32
    di = FREF.attention_di(o, tdo)
    dq = FA.flash_bwd_dq(tq, tk, tv, tdo, lse, di, **kw)
    dk, dv = FA.flash_bwd_dkv(tq, tk, tv, tdo, lse, di, **kw)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.float16) for a in (q, k, v, do))
    for backend in ("pallas_interpret", "xla"):
        jo, jlse = _jax_fwd(jq, jk, jv, backend=backend, **kw)
        assert jo.dtype == jnp.float16
        assert _rel(o, jo) <= O_TOL, (backend, _rel(o, jo))
        assert np.abs(lse.numpy() - np.asarray(jlse)).max() <= LSE_TOL
        want = _jax_bwd(jq, jk, jv, jnp.asarray(o.float().numpy()).astype(jnp.float16), jdo,
                        jnp.asarray(lse.numpy()), jnp.asarray(di.numpy()), backend=backend,
                        **kw)
        for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            assert _rel(got, w) <= BWD_TOL, (backend, name, _rel(got, w))


@pytest.mark.parametrize("causal", [True, False])
def test_f16_flash_attention_grads_match_jax(causal):
    """The differentiable ``flash_attention`` in f16 against ``jax.vjp`` of
    the JAX package's on its Pallas backend (interpret): o and the f16
    gradients within one f16 ulp of their max."""
    rng = np.random.default_rng(12)
    B, S, H, KV, hd = 2, 24, 6, 2, 80
    q, do = _f16(rng, (B, S, H, hd), (B, S, H, hd))
    k, v = _f16(rng, (B, S, KV, hd), (B, S, KV, hd))
    tq, tk, tv = (torch.from_numpy(a).half().requires_grad_() for a in (q, k, v))
    o = FA.flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do).half())
    jo, vjp = jax.vjp(lambda a, b, c: JFA.flash_attention(a, b, c, causal=causal,
                                                          backend="pallas_interpret"),
                      *(jnp.asarray(a, jnp.float16) for a in (q, k, v)))
    assert o.dtype == torch.float16 and _rel(o.detach(), jo) <= O_TOL
    for got, want in zip(grads, vjp(jnp.asarray(do, jnp.float16))):
        assert got.dtype == torch.float16
        assert _rel(got, want) <= O_TOL, _rel(got, want)


def test_decode_stays_f32_and_bf16():
    q = torch.zeros((1, 1, 2, 8), dtype=torch.float16)
    with pytest.raises(TypeError):
        FA.decode_attention(q, q, q, torch.ones(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the linear
# ---------------------------------------------------------------------------

def _linear_both(jpol, tpol, x, w, g):
    def jf(x, w):
        return JP.quant_linear(x.astype(jpol.compute_dtype),
                               JPRM.use_weight(w, ("embed", "mlp"), jpol.compute_dtype),
                               policy=jpol)
    y, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g).astype(y.dtype))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    ty = TP.quant_linear(tx.to(tpol.compute_dtype), PRM.use_weight(tw, (), tpol.compute_dtype),
                         policy=tpol)
    tdx, tdw = torch.autograd.grad(ty, (tx, tw), torch.from_numpy(g).to(ty.dtype))
    return ((np.asarray(y, np.float32), ty.detach().float().numpy()),
            (np.asarray(jdx, np.float32), tdx.numpy()), (np.asarray(jdw), tdw.numpy()))


def test_fp16_linear_is_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 8)) * 0.2).astype(np.float32)
    g = rng.standard_normal((16, 8)).astype(np.float32)
    for scale in (1.0, 16384.0):                    # 16384: Ẇ overflows f16, Ẏ not
        pairs = _linear_both(*FP16_POLICIES, x, w, g * scale)
        for want, got in pairs:
            np.testing.assert_array_equal(got, want)
        assert (scale == 1.0) == bool(np.isfinite(pairs[2][1]).all())


@pytest.mark.parametrize("cd", list(FP32_POLICIES))
def test_fp32_linear_runs_f32_products(cd):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 8)) * 0.2).astype(np.float32)
    g = rng.standard_normal((16, 8)).astype(np.float32)
    pairs = _linear_both(*FP32_POLICIES[cd], x, w, g)
    assert pairs[0][1].dtype == np.float32
    for want, got in pairs:
        assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()


def test_policies_and_train_config():
    """``FP16`` is f16 compute; ``from_train_config`` keeps bf16 compute for
    every mode, fp16 and fp32 included, as the reference does."""
    assert TP.FP16.compute_dtype == torch.float16 and TP.FP16.mode == "fp16"
    for mode in ("fp16", "fp32"):
        assert TP.QuantPolicy.from_train_config(TrainConfig(quant_mode=mode)).compute_dtype \
            == torch.bfloat16
        assert JP.QuantPolicy.from_train_config(JTrain(quant_mode=mode)).compute_dtype \
            == jnp.bfloat16


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

_SMOLLM: dict = {}


def _smollm_setup():
    if not _SMOLLM:
        jcfg, tcfg = jax_reduced("smollm-360m"), get_reduced_config("smollm-360m")
        jp = jax_init_params(jax_build(jcfg).param_specs, jax.random.PRNGKey(0))
        _SMOLLM["v"] = (jcfg, tcfg, jp, jax.tree.map(np.asarray, jp))
    return _SMOLLM["v"]


def _smollm_batches(vocab, n):
    from repro.data import BigramLM as JBigram
    from repro_torch.data import BigramLM
    mine, theirs = BigramLM(vocab, temperature=0.2), JBigram(vocab, temperature=0.2)
    out = []
    for _ in range(n):
        a, b = mine.batch(4, 16), theirs.batch(4, 16)
        assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))
        out.append(a)
    return out


def _steps(model, jpol, tpol, scaler, scan_layers=True, remat="none", lsi=None):
    """3 steps on each side: (JAX history, port history, JAX params, port
    params, initial params), histories of (loss, grad norm, loss scale,
    skipped tensors)."""
    keys = ("loss", "grad_norm", "loss_scale", "n_skipped_tensors")
    if model == "clip":
        jcfg, tcfg, jparams, np_params = TCLIP._setup(lsi)
        raw = TCLIP._batches(tcfg, N_STEPS)
        tbundle = TCLIP._port_bundle(tcfg, TCLIP._jax_patch_keeps(jcfg, N_STEPS))
        tbatches = [{"images": torch.from_numpy(b["images"]),
                     "texts": torch.from_numpy(b["texts"]).long()} for b in raw]
        lr = 3e-4
    else:
        jcfg, tcfg, jparams, np_params = _smollm_setup()
        raw = _smollm_batches(tcfg.vocab_size, N_STEPS)
        tbundle = build(tcfg)
        tbatches = [{k: torch.from_numpy(v).long() for k, v in b.items()} for b in raw]
        lr = 3e-3
    kw = dict(learning_rate=lr, warmup_steps=2, total_steps=N_STEPS, quant_mode=jpol.mode,
              loss_scaler=scaler)
    tc = JTrain(**kw)
    opt, sc = JTS.make_train_setup(tc)
    step = JTS.make_train_step(jax_build(jcfg), jpol, JParallel(
        mesh_shape=(1, 1), remat=remat, scan_layers=scan_layers), tc, opt, sc)
    state = JTS.init_train_state(jparams, opt, sc)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in raw]
    compiled = jax.jit(step).lower(state, jb[0]).compile(compiler_options=XLA)
    j_hist = []
    for b in jb:
        state, m = compiled(state, b)
        j_hist.append([float(m[k]) for k in keys])
    tc = TrainConfig(**kw)
    opt, sc = make_train_setup(tc)
    tstep = make_train_step(tbundle, tpol, ParallelConfig(remat=remat), tc, opt, sc)
    tstate = init_train_state(from_numpy_tree(np_params, device="cpu"), opt, sc)
    t_hist = []
    for b in tbatches:
        tstate, m = tstep(tstate, b)
        t_hist.append([float(m[k]) for k in keys])
    return (np.array(j_hist), np.array(t_hist), TCLIP._flat(state.params),
            TCLIP._flat(tstate.params), TCLIP._flat(np_params))


def _check_steps(model, j_hist, t_hist, j_params, t_params, p0):
    loss0, loss_tol, gnorm_tol, delta_tol = STEP_TOL[model]
    # the scaler's sequence and the skips, exactly
    np.testing.assert_array_equal(t_hist[:, 2:], j_hist[:, 2:])
    for i, (t, j) in enumerate(zip(t_hist, j_hist)):
        tol = loss0 if i == 0 else loss_tol
        assert np.isfinite(t[0]) and abs(t[0] - j[0]) <= tol * abs(j[0]), (i, t, j)
        if np.isfinite(j[1]):
            assert abs(t[1] - j[1]) <= gnorm_tol * j[1], (i, t, j)
        else:                                       # a tensor overflowed on both sides
            assert not np.isfinite(t[1]), (i, t, j)
    errs = TCLIP._leaf_errs({k: t_params[k] - p0[k] for k in p0},
                            {k: j_params[k] - p0[k] for k in p0})
    bad = {k: e for k, e in errs.items() if e[1] > delta_tol and not k.endswith("/bk")}
    assert not bad, ("each leaf's change over the steps (max, mean)", bad, delta_tol)
    # the same tensors kept as they were (skipped on every step, or no
    # gradient) on both sides
    assert ({k for k in p0 if np.array_equal(t_params[k], p0[k])}
            == {k for k in p0 if np.array_equal(j_params[k], p0[k])})


@pytest.mark.parametrize("model", ["clip", "smollm"])
@pytest.mark.parametrize("scaler", ["fixed_tensor", "dynamic"])
def test_fp16_steps_match_jax(model, scaler):
    """The paper's fp16 training: the same overflows, skips and scales."""
    j_hist, t_hist, j_params, t_params, p0 = _steps(model, *FP16_POLICIES, scaler)
    _check_steps(model, j_hist, t_hist, j_params, t_params, p0)
    if model == "clip":                              # the reduced CLIP overflows in f16
        assert (t_hist[:, 3] > 0).all()
    if scaler == "fixed_tensor":                     # and still updates
        assert any(not np.array_equal(t_params[k], p0[k]) for k in p0)
        assert (t_hist[:, 2] == 65536.0).all()


@pytest.mark.parametrize("model", ["clip", "smollm"])
@pytest.mark.parametrize("cd", list(FP32_POLICIES))
def test_fp32_steps_match_jax(model, cd):
    j_hist, t_hist, j_params, t_params, p0 = _steps(model, *FP32_POLICIES[cd], "none",
                                                    scan_layers=cd == "f32")
    _check_steps(model, j_hist, t_hist, j_params, t_params, p0)
    assert (t_hist[:, 3] == 0).all() and np.isfinite(t_hist).all()


def test_reference_cannot_scan_fp32_with_bf16_compute():
    """Pins the reference's caveat (ROADMAP.md Queue 3): its scanned CLIP
    under ``fp32`` with bf16 compute raises, which is why the port is held
    to the unscanned run."""
    jcfg, _, jparams, _ = TCLIP._setup(None)
    raw = TCLIP._batches(get_reduced_config("clip-vit-huge"), 1)[0]
    tc = JTrain(quant_mode="fp32")
    opt, sc = JTS.make_train_setup(tc)
    step = JTS.make_train_step(jax_build(jcfg), JP.QuantPolicy.from_train_config(tc),
                               JParallel(mesh_shape=(1, 1), remat="none"), tc, opt, sc)
    with pytest.raises(TypeError):
        step(JTS.init_train_state(jparams, opt, sc), {k: jnp.asarray(v) for k, v in raw.items()})


def test_launch_clis_turn_off_reduced_precision_products(capsys):
    """Both CLIs set TF32 and the 16-bit reduced-precision reductions off
    before they build anything (the flags exist on a CPU build too); the
    train CLI runs CLIP with ``fp16``, the dynamic scaler and AdaFactor."""
    from repro_torch.launch import serve, train
    for launch, argv in ((train, ["--arch", "clip-vit-huge", "--steps", "2", "--batch", "4",
                                  "--quant-mode", "fp16", "--loss-scaler", "dynamic",
                                  "--optimizer", "adafactor"]),
                         (serve, ["--n-requests", "1", "--new-tokens", "2", "--max-len", "16"])):
        m = torch.backends.cuda.matmul
        m.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        m.allow_bf16_reduced_precision_reduction = True
        m.allow_fp16_reduced_precision_reduction = True
        try:
            launch.main([*argv, "--device", "cpu"])
            assert TP.product_flags() == dict.fromkeys(TP.product_flags(), False), launch
            assert launch is serve or "final loss:" in capsys.readouterr().out
        finally:
            m.allow_bf16_reduced_precision_reduction = True
            m.allow_fp16_reduced_precision_reduction = True
            torch.backends.cudnn.allow_tf32 = True
            m.allow_tf32 = False
