"""The port's fp8 training path against the JAX package's, on the CPU.

* The four fp8 SwitchBack variants (``fp8``, ``fp8_mixed``, ``fp8_sim``,
  ``fp8_switchback``) as autograd functions: y, Ẋ and Ẇ against
  ``jax.vjp`` of ``switchback_linear(variant, backend="pallas_interpret")``
  (the Pallas fp8 kernels interpreted; the simulated variants ignore the
  backend), bf16 and f32 compute, with outlier tiles so that
  ``fp8_mixed`` takes both branches. Tolerances: ``fp8`` and ``fp8_mixed``
  sum each k-block or tile exactly where the JAX kernels' in-block f32
  dot rounds in XLA's order, and the simulated variants' f32 products sum
  in another order than XLA's; either way the f32 results sit an ulp or
  so apart, and y and Ẋ may round to the neighbouring value of the output
  type: Y_TOL, one ulp at max|y|. Ẇ sums the same products in another
  order: DW_TOL of max|Ẇ|.
* One CLIP step at 2 + 2 narrow layers (the reduced clip-vit-huge with
  two vision layers) per fp8 mode: loss and every gradient leaf against
  ``jax.value_and_grad`` of the JAX package's ``clip_loss`` on the same
  parameters, batch and kept patches, jitted with XLA's excess precision
  off (its ``xla`` backend: the fp8 kernels' reference, blocked as the
  kernels are). A last-bit difference in an activation now and then moves
  one value by a quantization step, which is 2^-4 (E4M3) or 2^-3 (E5M2)
  of it: LOSS_TOL, GRAD_TOL per leaf (max and mean |diff| over max|JAX|),
  by the port's attention. The yardstick is the JAX package against
  itself: the same step jitted with XLA's excess precision on and off
  reads up to 2.1e-1 (max) and 3.7e-2 (mean) apart in fp8 and fp8_sim,
  and 1.4e-2 in the loss. Under ``dense`` attention the port's step
  rounds as JAX's does up to the quantizers' inputs (measured max 3.6e-2,
  mean 2.0e-3, loss equal); under ``flash_scan`` (another order of the
  softmax sums) and for ``fp8_sim`` (whose f32 products sum in another
  order), the quantizers turn last-bit differences into steps (measured
  max 1.7e-1, mean 2.3e-2, loss 2.5e-6). ``fp8_mixed`` runs with 16 x 32
  tiles and ratio 2, so its reduced widths hold several tiles and some
  fall back.
* ``fp8_mixed`` at its default 128 x 128 tiles and fallback ratio, where
  the JAX package rounds each tile's f32 dot and the port sums each tile
  exactly and rounds once (the kernels' bit-equality on the card rests on
  that): loss and every gradient leaf against JAX's, within limits derived
  in the test from the yardstick, the same step of the JAX package jitted
  with XLA's excess precision on against off (``_default_tile_jax``).
* One train step through ``make_train_step`` per fp8 mode: loss and grad
  norm alike, and the same metric keys (the quant-health gauges, the
  ``fp8_mixed`` fallback fraction included).
* The ``fp8_fallback_frac`` gauge of ``telemetry/health.py`` against the
  JAX package's on the same parameters and gradients.
* ``--fp8-block`` and ``--fp8-fallback-ratio`` through
  ``launch/train.py`` into the policy and the TrainConfig.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.core import switchback as JSB
from repro.core.precision import QuantPolicy as JPolicy
from repro.data import SyntheticCLIP as JSyntheticCLIP
from repro.models import build as jax_build
from repro.models import clip as JCL
from repro.models.params import init_params as jax_init_params
from repro.telemetry import health as JH
from repro.train import train_step as JTS
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import switchback as TSB
from repro_torch.core.precision import QuantPolicy
from repro_torch.models import build
from repro_torch.models.params import from_numpy_tree
from repro_torch.telemetry import health as TH
from repro_torch.train import init_train_state, loss_and_grads, make_train_setup, make_train_step

torch.set_num_threads(1)

VARIANTS = ("fp8", "fp8_mixed", "fp8_sim", "fp8_switchback")
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}
Y_TOL = {"bf16": 2.0 ** -7, "f32": 2.0 ** -21}
DW_TOL = 1e-6
BLOCK = dict(block_rows=64, block_cols=32, fallback_ratio=4.0)

ARCH = "clip-vit-huge"
BATCH = 4
XLA = {"xla_allow_excess_precision": False}
# fp8_mixed's knobs in the CLIP cases: several tiles at the reduced widths
MIXED_POLICY = dict(fp8_block_rows=16, fp8_block_cols=32, fp8_fallback_ratio=2.0)
# (mode, layer_scale_init, the port's attn_impl): fp8_sim with zero-init
# layer-scale, the paper's recipe, and without it (where its block weights
# get gradients)
CLIP_CASES = [("fp8", None, "dense"), ("fp8_mixed", None, "dense"),
              ("fp8_mixed", None, "flash_scan"), ("fp8_sim", 0.0, "flash_scan"),
              ("fp8_sim", None, "flash_scan"), ("fp8_switchback", None, "dense")]
# loss relative; per leaf (max, mean) |diff| over max|JAX| (module
# docstring); a gradient of the wrong sign or a missing scale reads far above
LOSS_TOL = 1e-4
GRAD_TOL = {"dense": (5e-2, 5e-3), "flash_scan": (2.5e-1, 4e-2)}
# fp8_mixed at its defaults (128 x 128 tiles, ratio 8). The limits are the
# yardstick's own readings, taken in the test: the loss's relative
# difference and the worst leaf's max and mean |diff| over max|JAX| between
# the JAX step with excess precision on and off. When this test was
# written they read 1.87e-2 / 2.31e-1 / 3.94e-2, and the port 1.0e-7 /
# 7.7e-2 / 1.2e-2 (dense) and 1.0e-7 / 1.0e-1 / 1.4e-2 (flash_scan). The
# yardstick may not exceed DEFAULT_TILE_CEILING, so that the derived limits
# cannot grow loose unseen.
DEFAULT_TILE_POLICY = dict(fp8_block_rows=128, fp8_block_cols=128)
DEFAULT_TILE_CEILING = (5e-2, 5e-1, 1e-1)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)


def _rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


# ---------------------------------------------------------------------------
# the four variants
# ---------------------------------------------------------------------------

def _variant_inputs(rows, N, M, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, N)) * 3).astype(np.float32)
    x[2] = 0.0                                     # all-zero row
    x[:64, :32] *= 50.0                            # an outlier tile of X
    w = (rng.standard_normal((N, M)) / np.sqrt(N)).astype(np.float32)
    w = _np(torch.from_numpy(w).to(torch.bfloat16))   # as use_weight hands it over
    g = rng.standard_normal((rows, M)).astype(np.float32)
    g[:64, 32:64] *= 50.0                          # and one of Ẏ
    return x, w, g


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_grads_match_jax(variant, dt):
    jdt, tdt = DTYPES[dt]
    x, w, g = _variant_inputs(150, 96, 80, len(variant) + len(dt))
    x, g = _np(torch.from_numpy(x).to(tdt)), _np(torch.from_numpy(g).to(tdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    fp8 = TSB.FP8Config(**BLOCK)
    y = TSB.switchback_linear(tx, tw, variant=variant, compute_dtype=tdt, fp8=fp8)
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(g).to(tdt))
    assert y.dtype == dx.dtype == tdt and dw.dtype == torch.float32
    jy, vjp = jax.vjp(lambda a, b: JSB.switchback_linear(a, b, variant=variant,
                                                         backend="pallas_interpret", **BLOCK),
                      jnp.asarray(x, jdt), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g, jdt))
    assert _rel(y, jy) <= Y_TOL[dt], ("y", _rel(y, jy))
    assert _rel(dx, jdx) <= Y_TOL[dt], ("dx", _rel(dx, jdx))
    assert _rel(dw, jdw) <= DW_TOL, ("dw", _rel(dw, jdw))


def test_fp8_mixed_falls_back_on_the_outlier_tiles():
    """With the outlier tiles of X and Ẏ falling back to bf16, y and Ẋ are
    nearer the bf16 product than with every tile in fp8."""
    x, w, g = _variant_inputs(150, 96, 80, 1)
    tx, tw, tg = (torch.from_numpy(a) for a in (x, w, g))

    def run(ratio):
        txr = tx.clone().requires_grad_()
        y = TSB.switchback_linear(txr, tw, variant="fp8_mixed", compute_dtype=torch.float32,
                                  fp8=TSB.FP8Config(**dict(BLOCK, fallback_ratio=ratio)))
        return y.detach(), torch.autograd.grad(y, txr, tg)[0]

    exact_y, exact_dx = tx @ tw, tg @ tw.t()
    (y8, dx8), (ym, dxm) = run(1e30), run(4.0)
    err = lambda a, b: float((a[:64] - b[:64]).abs().max())
    assert err(ym, exact_y) < err(y8, exact_y) and err(dxm, exact_dx) < err(dx8, exact_dx)


# ---------------------------------------------------------------------------
# one CLIP step per fp8 mode
# ---------------------------------------------------------------------------

_SETUP: dict = {}


def _setup(lsi):
    if lsi not in _SETUP:
        jcfg = dataclasses.replace(jax_reduced(ARCH), vision_layers=2, layer_scale_init=lsi)
        tcfg = dataclasses.replace(get_reduced_config(ARCH), vision_layers=2,
                                   layer_scale_init=lsi)
        jp = jax_init_params(jax_build(jcfg).param_specs, jax.random.PRNGKey(1))
        mine = JSyntheticCLIP(jcfg.image_size, jcfg.text_ctx, jcfg.text_vocab, n_classes=32)
        b = mine.batch(BATCH)
        batch = {"images": b["images"], "texts": b["texts"]}
        _SETUP[lsi] = (jcfg, tcfg, jp, jax.tree.map(np.asarray, jp), batch)
    return _SETUP[lsi]


def _policies(mode):
    kw = MIXED_POLICY if mode == "fp8_mixed" else {}
    return JPolicy(mode, **kw), QuantPolicy(mode, **kw)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {prefix: np.asarray(tree, np.float64)}


@pytest.mark.parametrize("mode,lsi,impl", CLIP_CASES,
                         ids=[f"{m}-lsi{l}-{i}" for m, l, i in CLIP_CASES])
def test_clip_step_loss_and_grads_match_jax(mode, lsi, impl):
    jcfg, tcfg, jparams, np_params, batch = _setup(lsi)
    jpol, tpol = _policies(mode)
    parallel = JParallel(mesh_shape=(1, 1), remat="none")
    sub = jax.random.split(jax.random.PRNGKey(0))[1]
    keep = max(1, int(jcfg.n_patches * (1 - jcfg.patch_dropout)))
    kept = np.asarray(jax.random.permutation(sub, jcfg.n_patches)[:keep])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p, b):
        return JCL.clip_loss(p, b, jcfg, jpol, parallel, patch_drop_rng=sub)

    (j_loss, _), j_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True)).lower(
        jparams, jb).compile(compiler_options=XLA)(jparams, jb)
    t_grad, t_loss, _ = loss_and_grads(
        build(tcfg), tpol, ParallelConfig(remat="none", attn_impl=impl),
        from_numpy_tree(np_params, device="cpu"),
        {"images": torch.from_numpy(batch["images"]), "texts": torch.from_numpy(batch["texts"])},
        patch_keep=torch.tensor(kept))
    assert np.isfinite(float(t_loss))
    assert abs(float(t_loss) - float(j_loss)) <= LOSS_TOL * abs(float(j_loss))
    t_flat, j_flat = _flat(t_grad), _flat(j_grad)
    assert set(t_flat) == set(j_flat)
    bad = {}
    for k, jg in j_flat.items():
        top = np.abs(jg).max() or 1.0
        d = np.abs(t_flat[k] - jg)
        if k.endswith("/bk"):               # exact gradient 0: rounding noise on both sides
            continue
        if d.max() / top > GRAD_TOL[impl][0] or d.mean() / top > GRAD_TOL[impl][1]:
            bad[k] = (d.max() / top, d.mean() / top)
    assert not bad, (mode, bad)
    if lsi == 0.0:                          # γ = 0: the blocks' weights get no gradient
        assert not np.abs(t_flat["/visual/blocks/mlp/w_up"]).any()


_YARDSTICK: dict = {}


def _leaf_readings(got: dict, want: dict):
    """Per leaf (max, mean) |got - want| over max|want|, the key bias left
    out (its exact gradient is 0: rounding noise on both sides)."""
    out = {}
    for k, w in want.items():
        if not k.endswith("/bk"):
            top = np.abs(w).max() or 1.0
            d = np.abs(got[k] - w)
            out[k] = (d.max() / top, d.mean() / top)
    return out


def _default_tile_jax():
    """JAX's fp8_mixed step at the default tiles, jitted with excess
    precision off (the reference) and on (the yardstick), and the limits
    (loss, leaf max, leaf mean) the yardstick reads."""
    if not _YARDSTICK:
        jcfg, _, jparams, _, batch = _setup(None)
        jpol = JPolicy("fp8_mixed", **DEFAULT_TILE_POLICY)
        parallel = JParallel(mesh_shape=(1, 1), remat="none")
        sub = jax.random.split(jax.random.PRNGKey(0))[1]
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def jloss(p, b):
            return JCL.clip_loss(p, b, jcfg, jpol, parallel, patch_drop_rng=sub)

        for excess in (False, True):
            (loss, _), grad = jax.jit(jax.value_and_grad(jloss, has_aux=True)).lower(
                jparams, jb).compile(compiler_options={"xla_allow_excess_precision": excess})(
                jparams, jb)
            _YARDSTICK[excess] = (float(loss), _flat(grad))
        (l_off, g_off), (l_on, g_on) = _YARDSTICK[False], _YARDSTICK[True]
        leaves = _leaf_readings(g_on, g_off).values()
        _YARDSTICK["limits"] = (abs(l_on - l_off) / abs(l_off), max(r[0] for r in leaves),
                                max(r[1] for r in leaves))
    return _YARDSTICK[False], _YARDSTICK["limits"]


@pytest.mark.parametrize("impl", ["dense", "flash_scan"])
def test_clip_step_fp8_mixed_default_tiles_matches_jax(impl):
    """fp8_mixed at 128 x 128 tiles and the default ratio: the loss and
    every gradient leaf within the JAX-vs-JAX yardstick's readings
    (derived in ``_default_tile_jax``), the yardstick itself under
    DEFAULT_TILE_CEILING."""
    jcfg, tcfg, _, np_params, batch = _setup(None)
    (j_loss, j_flat), limits = _default_tile_jax()
    assert all(lim <= ceil for lim, ceil in zip(limits, DEFAULT_TILE_CEILING)), limits
    sub = jax.random.split(jax.random.PRNGKey(0))[1]
    keep = max(1, int(jcfg.n_patches * (1 - jcfg.patch_dropout)))
    kept = np.asarray(jax.random.permutation(sub, jcfg.n_patches)[:keep])
    t_grad, t_loss, _ = loss_and_grads(
        build(tcfg), QuantPolicy("fp8_mixed", **DEFAULT_TILE_POLICY),
        ParallelConfig(remat="none", attn_impl=impl), from_numpy_tree(np_params, device="cpu"),
        {"images": torch.from_numpy(batch["images"]), "texts": torch.from_numpy(batch["texts"])},
        patch_keep=torch.tensor(kept))
    t_flat = _flat(t_grad)
    assert set(t_flat) == set(j_flat)
    assert abs(float(t_loss) - j_loss) <= limits[0] * abs(j_loss)
    bad = {k: r for k, r in _leaf_readings(t_flat, j_flat).items()
           if r[0] > limits[1] or r[1] > limits[2]}
    assert not bad, (limits, bad)


@pytest.mark.parametrize("mode", ("fp8", "fp8_mixed", "fp8_sim", "fp8_switchback"))
def test_clip_train_step_matches_jax(mode):
    """One step through each package's ``make_train_step`` (StableAdamW, the
    quant-health gauges on): loss and grad norm alike, the same metric
    keys, each group's w_absmax and fallback fraction alike."""
    jcfg, tcfg, jparams, np_params, batch = _setup(None)
    jpol, tpol = _policies(mode)
    kw = MIXED_POLICY if mode == "fp8_mixed" else {}
    jtc = JTrain(learning_rate=3e-4, warmup_steps=2, total_steps=2, quant_mode=mode, **kw)
    ttc = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=2, quant_mode=mode, **kw)
    assert QuantPolicy.from_train_config(ttc) == tpol
    opt, scaler = JTS.make_train_setup(jtc)
    jstep = JTS.make_train_step(jax_build(jcfg), jpol, JParallel(mesh_shape=(1, 1), remat="none"),
                                jtc, opt, scaler)
    jstate = JTS.init_train_state(jparams, opt, scaler)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jm = jax.jit(jstep).lower(jstate, jb).compile(compiler_options=XLA)(jstate, jb)
    rng = jax.random.split(jax.random.PRNGKey(0))[1]
    keep = max(1, int(jcfg.n_patches * (1 - jcfg.patch_dropout)))
    kept = torch.tensor(np.asarray(jax.random.permutation(rng, jcfg.n_patches)[:keep]))
    bundle = dataclasses.replace(build(tcfg), patch_keep=lambda gen: kept)
    opt, scaler = make_train_setup(ttc)
    tstep = make_train_step(bundle, tpol, ParallelConfig(remat="none"), ttc, opt, scaler)
    _, tm = tstep(init_train_state(from_numpy_tree(np_params, device="cpu"), opt, scaler),
                  {"images": torch.from_numpy(batch["images"]),
                   "texts": torch.from_numpy(batch["texts"])})
    assert set(tm) == set(jm)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL * abs(float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 2e-2 * float(jm["grad_norm"])
    qh = [k for k in jm if k.startswith("qh/")]
    assert any(k.endswith("w_absmax") for k in qh)
    assert any(k.endswith("fp8_fallback_frac") for k in qh) == (mode == "fp8_mixed")
    for k in qh:
        want = float(jm[k])
        assert abs(float(tm[k]) - want) <= 1e-2 * abs(want) + 1e-6, (k, float(tm[k]), want)


# ---------------------------------------------------------------------------
# the fallback gauge and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ratio", [2.0, 8.0])
def test_fp8_fallback_frac_gauge_matches_jax(ratio):
    """``quant_health`` in fp8_mixed on the same parameters and gradients
    (numpy trees of CLIP's groups, stacked layer dims folded into rows,
    spiky gradients so that some tiles exceed the ratio): every gauge alike,
    the fallback fractions to the last bit of their mean."""
    rng = np.random.default_rng(int(ratio))

    def leaf(*shape, spike=False):
        a = rng.standard_normal(shape).astype(np.float32)
        if spike:
            a.reshape(-1, shape[-1])[rng.integers(0, a.size // shape[-1], 3), 0] *= 40.0
        return a

    params = {"embed": leaf(50, 24), "blocks": {"attn": {"wq": leaf(2, 24, 24)},
                                                "mlp": {"w_up": leaf(2, 24, 96)}},
              "head": leaf(24, 10), "norm": leaf(24)}
    grads = {"embed": leaf(50, 24, spike=True),
             "blocks": {"attn": {"wq": leaf(2, 24, 24, spike=True)},
                        "mlp": {"w_up": leaf(2, 24, 96, spike=True)}},
             "head": leaf(24, 10, spike=True), "norm": leaf(24)}
    kw = dict(quant_mode="fp8_mixed", fp8_block_rows=8, fp8_block_cols=8,
              fp8_fallback_ratio=ratio)
    want = JH.quant_health(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
                           JTrain(**kw))
    got = TH.quant_health(from_numpy_tree(params, device="cpu"),
                          from_numpy_tree(grads, device="cpu"), TrainConfig(**kw))
    assert set(got) == set(want) and any(k.endswith("fp8_fallback_frac") for k in got)
    fracs = [float(v) for k, v in got.items() if k.endswith("fp8_fallback_frac")]
    assert any(0 < f < 1 for f in fracs)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-6 * max(1.0, abs(float(want[k]))), k


def test_train_cli_fp8_flags_reach_the_policy(monkeypatch, capsys):
    from repro_torch.launch import train as CLI
    from repro_torch.train import engine
    seen = {}
    real = engine.make_train_step

    def spy(bundle, policy, parallel, tc, opt, scaler, **kw):
        seen.update(policy=policy, tc=tc)
        return real(bundle, policy, parallel, tc, opt, scaler, **kw)

    # the launcher trains through the engine, which builds the step
    monkeypatch.setattr(engine, "make_train_step", spy)
    CLI.main(["--arch", ARCH, "--device", "cpu", "--steps", "1", "--batch", "4",
              "--quant-mode", "fp8_mixed", "--fp8-block", "16", "32",
              "--fp8-fallback-ratio", "3.5"])
    pol, tc = seen["policy"], seen["tc"]
    assert (pol.mode, pol.fp8_block_rows, pol.fp8_block_cols, pol.fp8_fallback_ratio) == \
        ("fp8_mixed", 16, 32, 3.5)
    assert (tc.fp8_block_rows, tc.fp8_block_cols, tc.fp8_fallback_ratio) == (16, 32, 3.5)
    out = capsys.readouterr().out
    assert "fp8_mixed tile 16 x 32, fallback ratio 3.5" in out and "final loss:" in out
    CLI.main(["--arch", ARCH, "--device", "cpu", "--steps", "1", "--batch", "4",
              "--quant-mode", "fp8"])
    assert (seen["policy"].mode, seen["policy"].fp8_block_rows,
            seen["policy"].fp8_fallback_ratio) == ("fp8", 128, 8.0)
