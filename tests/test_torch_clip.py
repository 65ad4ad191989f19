"""The port's CLIP (the paper's own model) against the JAX package's, on the CPU.

The reduced ``clip-vit-huge`` (vision 3 layers of width 96, text 2 of 64,
32 px images in 8 px patches, patch dropout 0.5). The JAX package's
parameters (``init_params`` from a PRNG key) are carried across with
``from_numpy_tree``, the 0-d ``logit_scale`` and the layer-scale γ
included, and both sides train on the same ``SyntheticCLIP`` batches (the
port's copy draws the JAX generator's numbers) with the same
``TrainConfig``: StableAdamW, warmup-cosine lr, no loss scaling. JAX
draws each step's kept patches from its state's PRNG key (threefry,
which torch cannot replay); the port's step takes those same indices
(the bundle's ``patch_keep`` replaced by a feed of JAX's draws), in the
unsorted order JAX keeps them. Modes ``bf16`` and the four int8 modes;
``layer_scale_init`` None and 0.0 (the paper's zero-init recipe, under
which every block is the identity at step 0). The JAX side runs on its
``xla`` backend (dense attention; the int8 variants' XLA path), jitted
with XLA's excess precision off; the port runs its flash functions
(plain versions on the CPU) or its dense attention.

Tolerances. The yardstick is the JAX package against itself: its two
backends (``xla`` and ``pallas_interpret``) on these same cases read, for
bf16 / int8_llm, loss 0 / 1.6e-3 apart at the first step (the same
parameters) and 7.3e-3 / 1.9e-2 at the third, grad norm 9e-4 / 5.7e-3 at
the first step and up to 1.8e-2 later, final parameters up to 1.2e-2 /
2.2e-2 per leaf (mean |diff| over the leaf's max). The port differs from
JAX's xla backend for the same reasons: dense attention against flash
(or the port's own dense attention, whose softmax rounds elsewhere), the
column-wise variants' scale formed in another order on JAX's XLA path
(``s_x * (s_w / 127²)`` against the kernel path's ``(s_x / 127²) * s_w``,
one f32 rounding), a last-bit difference turning into a bf16 rounding or
an int8 quantization step of an activation, and Adam turning a
near-zero gradient of either sign into a step of ±lr (zero-init biases
hold many such elements, so their leaf's max is a few lr). Hence: the
first step (LOSS0_TOL, GNORM0_TOL, contrastive accuracy equal), later
steps (LOSS_TOL, GNORM_TOL), each leaf's change over the steps, p_T - p_0
(DELTA_MEAN_TOL, mean |diff| over the largest change JAX made in that
leaf: three steps at lr 3e-4 move a weight by about 1e-3 of its max, far
below what a comparison of p_T itself could see), the 0-d logit_scale's
change (LOGIT_SCALE_STEP_TOL, relative), and the first batch's gradient
per leaf (GRAD_TOL, max and mean |diff| over the leaf's max|JAX|). The key bias ``bk`` is left
out of the per-leaf comparisons: its exact gradient is 0 (softmax does
not change when one constant is added to all of a query's scores), so
both sides hold rounding noise there, which Adam turns into ±lr steps;
the tests check instead that its gradient is noise beside ``bq``'s.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.core.precision import QuantPolicy as JPolicy
from repro.data import SyntheticCLIP as JSyntheticCLIP
from repro.models import build as jax_build
from repro.models import clip as JCL
from repro.models.params import init_params as jax_init_params
from repro.train import train_step as JTS
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.data import SyntheticCLIP
from repro_torch.models import build
from repro_torch.models import clip as CL
from repro_torch.models.params import from_numpy_tree, init_params
from repro_torch.train import init_train_state, loss_and_grads, make_train_setup, make_train_step

torch.set_num_threads(1)

ARCH = "clip-vit-huge"
BATCH = 4
N_STEPS = 3
LOSS0_TOL, GNORM0_TOL = 2e-3, 2e-2
LOSS_TOL, GNORM_TOL = 3e-2, 3e-2
# each leaf's change p_T - p_0, mean |diff| over max|change in JAX| (sound
# readings up to 2.6e-2 over the five cases, bk left out); an update left
# out or of the wrong sign reads about 0.3 to 2
DELTA_MEAN_TOL = 5e-2
# the 0-d logit_scale's change, relative (sound readings up to 4.8e-3: a
# few f32 ulps of the value, whose change is about 3e-4)
LOGIT_SCALE_STEP_TOL = 1e-2
GRAD_TOL = (1e-1, 1e-2)
# bk's gradient (exactly 0) against bq's, max over max (measured <= 3.5e-3)
BK_NOISE = 1e-2
XLA = {"xla_allow_excess_precision": False}
# (mode, layer_scale_init, the port's attn_impl)
CASES = [
    ("int8_switchback", 0.0, "flash_scan"),
    ("int8_switchback_m", None, "flash_scan"),
    ("int8_switchback_q", None, "dense"),
    ("int8_llm", None, "flash_scan"),
    ("bf16", 0.0, "flash_scan"),
]

_SETUP: dict = {}


def _setup(lsi):
    """(JAX config, port config, JAX params, the same as numpy) for a
    layer_scale_init."""
    if lsi not in _SETUP:
        jcfg = dataclasses.replace(jax_reduced(ARCH), layer_scale_init=lsi)
        tcfg = dataclasses.replace(get_reduced_config(ARCH), layer_scale_init=lsi)
        jp = jax_init_params(jax_build(jcfg).param_specs, jax.random.PRNGKey(0))
        _SETUP[lsi] = (jcfg, tcfg, jp, jax.tree.map(np.asarray, jp))
    return _SETUP[lsi]


def _batches(cfg, n):
    """n SyntheticCLIP batches from the port's copy, checked against the
    JAX generator's draw for draw (class ids dropped, as the launchers do)."""
    mine = SyntheticCLIP(cfg.image_size, cfg.text_ctx, cfg.text_vocab, n_classes=32)
    theirs = JSyntheticCLIP(cfg.image_size, cfg.text_ctx, cfg.text_vocab, n_classes=32)
    out = []
    for _ in range(n):
        a, b = mine.batch(BATCH), theirs.batch(BATCH)
        assert all(np.array_equal(a[k], b[k]) for k in a)
        out.append({"images": a["images"], "texts": a["texts"]})
    return out


def _jax_patch_keeps(cfg, n, seed=0):
    """The kept patches of JAX's first ``n`` steps: its step splits the
    state's key and permutes the patches with the subkey."""
    rng, out = jax.random.PRNGKey(seed), []
    keep = max(1, int(cfg.n_patches * (1 - cfg.patch_dropout)))
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.permutation(sub, cfg.n_patches)[:keep]))
    return out


def _train_cfg(cls, mode, **kw):
    return cls(learning_rate=3e-4, warmup_steps=2, total_steps=N_STEPS, quant_mode=mode, **kw)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {prefix: np.asarray(tree, np.float64)}


def _leaf_errs(got: dict, want: dict) -> dict:
    out = {}
    for k, w in want.items():
        d = np.abs(got[k] - w)
        top = np.abs(w).max() or 1.0
        out[k] = (d.max() / top, d.mean() / top)
    return out


def _port_bundle(tcfg, keeps):
    """The port's bundle with its patch draw replaced by JAX's indices."""
    it = iter(keeps)
    return dataclasses.replace(build(tcfg), patch_keep=lambda gen: torch.tensor(next(it)))


def _jax_run(jcfg, jparams, batches, mode):
    bundle = jax_build(jcfg)
    tc = _train_cfg(JTrain, mode)
    opt, scaler = JTS.make_train_setup(tc)
    step = JTS.make_train_step(bundle, JPolicy(mode), JParallel(mesh_shape=(1, 1), remat="none"),
                               tc, opt, scaler)
    state = JTS.init_train_state(jparams, opt, scaler)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    compiled = jax.jit(step).lower(state, jb[0]).compile(compiler_options=XLA)
    hist = []
    for b in jb:
        state, m = compiled(state, b)
        hist.append({k: np.asarray(m[k]) for k in ("loss", "grad_norm", "contrastive_acc",
                                                  "logit_scale", "feature_stats")})
    return hist, _flat(state.params), _flat(jax.tree.map(np.asarray, m))


def _port_run(tcfg, np_params, batches, mode, impl, keeps):
    bundle = _port_bundle(tcfg, keeps)
    tc = _train_cfg(TrainConfig, mode)
    opt, scaler = make_train_setup(tc)
    step = make_train_step(bundle, QuantPolicy(mode), ParallelConfig(remat="none", attn_impl=impl),
                           tc, opt, scaler)
    state = init_train_state(from_numpy_tree(np_params, device="cpu"), opt, scaler)
    hist = []
    for b in batches:
        state, m = step(state, {"images": torch.from_numpy(b["images"]),
                                "texts": torch.from_numpy(b["texts"]).long()})
        hist.append({k: m[k].numpy() for k in ("loss", "grad_norm", "contrastive_acc",
                                               "logit_scale", "feature_stats")})
    return hist, _flat(state.params), _flat(m)


@pytest.mark.parametrize("mode,lsi,impl", CASES, ids=[f"{m}-lsi{l}-{i}" for m, l, i in CASES])
def test_clip_training_matches_jax(mode, lsi, impl):
    jcfg, tcfg, jparams, np_params = _setup(lsi)
    batches = _batches(tcfg, N_STEPS)
    keeps = _jax_patch_keeps(jcfg, N_STEPS)
    j_hist, j_params, j_metrics = _jax_run(jcfg, jparams, batches, mode)
    t_hist, t_params, t_metrics = _port_run(tcfg, np_params, batches, mode, impl, keeps)
    # the last step's metrics: the same keys (the quant-health scalars of
    # CLIP's groups included), each weight group's absmax alike
    assert set(t_metrics) == set(j_metrics)
    for k in (k for k in j_metrics if k.endswith("w_absmax")):
        assert abs(t_metrics[k] - j_metrics[k]) <= 1e-2 * j_metrics[k], (k, t_metrics[k])
    for i, (t, j) in enumerate(zip(t_hist, j_hist)):
        loss_tol, gnorm_tol = (LOSS0_TOL, GNORM0_TOL) if i == 0 else (LOSS_TOL, GNORM_TOL)
        assert np.isfinite(t["loss"]), (i, t)
        assert abs(t["loss"] - j["loss"]) <= loss_tol * abs(j["loss"]), (i, t["loss"], j["loss"])
        assert abs(t["grad_norm"] - j["grad_norm"]) <= gnorm_tol * j["grad_norm"], (
            i, t["grad_norm"], j["grad_norm"])
        assert i or t["contrastive_acc"] == j["contrastive_acc"], (i, t, j)
        assert abs(t["logit_scale"] - j["logit_scale"]) <= LOSS0_TOL * j["logit_scale"]
        assert t["feature_stats"].shape == j["feature_stats"].shape == (jcfg.vision_layers,)
    p0 = _flat(np_params)
    assert set(t_params) == set(j_params) == set(p0)
    errs = _leaf_errs({k: t_params[k] - p0[k] for k in p0}, {k: j_params[k] - p0[k] for k in p0})
    bad = {k: e for k, e in errs.items() if e[1] > DELTA_MEAN_TOL and not k.endswith("/bk")}
    assert not bad, ("each leaf's change over the steps (max, mean)", bad, DELTA_MEAN_TOL)
    d_t, d_j = (float(p["/logit_scale"] - p0["/logit_scale"]) for p in (t_params, j_params))
    assert d_j != 0.0 and abs(d_t - d_j) <= LOGIT_SCALE_STEP_TOL * abs(d_j), (d_t, d_j)


@pytest.mark.parametrize("mode", ["int8_llm", "bf16"])
def test_clip_loss_and_grads_match_jax(mode):
    """One batch's loss, metrics (``collect_stats`` on) and gradient, per
    leaf, with the patches JAX keeps; the 0-d logit_scale's gradient
    included."""
    jcfg, tcfg, jparams, np_params = _setup(None)
    batch = _batches(tcfg, 1)[0]
    keep = _jax_patch_keeps(jcfg, 1)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    policy, parallel = JPolicy(mode), JParallel(mesh_shape=(1, 1), remat="none")
    sub = jax.random.split(jax.random.PRNGKey(0))[1]

    def jloss(p, b):
        return JCL.clip_loss(p, b, jcfg, policy, parallel, patch_drop_rng=sub,
                             collect_stats=True)

    (j_loss, j_m), j_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True)).lower(
        jparams, jb).compile(compiler_options=XLA)(jparams, jb)
    bundle = build(tcfg)
    t_grad, t_loss, t_m = loss_and_grads(
        bundle, QuantPolicy(mode), ParallelConfig(remat="none"),
        from_numpy_tree(np_params, device="cpu"),
        {"images": torch.from_numpy(batch["images"]), "texts": torch.from_numpy(batch["texts"])},
        patch_keep=torch.tensor(keep), collect_stats=True)
    assert abs(float(t_loss) - float(j_loss)) <= LOSS0_TOL * abs(float(j_loss))
    assert float(t_m["contrastive_acc"]) == float(j_m["contrastive_acc"])
    stats, j_stats = t_m["feature_stats"].numpy(), np.asarray(j_m["feature_stats"])
    assert np.abs(stats - j_stats).max() <= LOSS0_TOL * np.abs(j_stats).max()
    t_flat, j_flat = _flat(t_grad), _flat(j_grad)
    errs = _leaf_errs(t_flat, j_flat)
    assert "/logit_scale" in errs and len(errs) == len(_flat(jparams))
    bad = {k: e for k, e in errs.items()
           if (e[0] > GRAD_TOL[0] or e[1] > GRAD_TOL[1]) and not k.endswith("/bk")}
    assert not bad, ("first batch's gradient", bad, GRAD_TOL)
    for tower in ("visual", "text"):
        for g in (t_flat, j_flat):
            bk, bq = g[f"/{tower}/blocks/attn/bk"], g[f"/{tower}/blocks/attn/bq"]
            assert np.abs(bk).max() <= BK_NOISE * np.abs(bq).max(), (tower, np.abs(bk).max())


def test_from_numpy_tree_carries_the_clip_tree():
    """Every leaf of the JAX tree (zero-init γ and the 0-d logit_scale
    included) arrives with its shape, dtype and values; the port's own
    init builds the same tree."""
    _, tcfg, _, np_params = _setup(0.0)
    tree = from_numpy_tree(np_params, device="cpu")
    flat_np, flat_t = _flat(np_params), _flat(tree)
    assert set(flat_np) == set(flat_t) == set(_flat(init_params(build(tcfg).param_specs, 0,
                                                                device="cpu")))
    for k, a in flat_np.items():
        np.testing.assert_array_equal(flat_t[k], a, err_msg=k)
    assert tree["logit_scale"].shape == () and tree["logit_scale"].dtype == torch.float32
    assert float(tree["visual"]["blocks"]["gamma1"].abs().max()) == 0.0


def test_patch_keep_sampler_draws_a_permutation_prefix():
    cfg = get_reduced_config(ARCH)
    draw = build(cfg).patch_keep
    keep = draw(torch.Generator().manual_seed(3))
    assert keep.shape == (CL.n_kept_patches(cfg),) == (8,)
    assert len(set(keep.tolist())) == 8 and 0 <= int(keep.min()) and int(keep.max()) < 16
    assert not torch.equal(keep, keep.sort().values)       # unsorted, as JAX keeps them
    assert build(dataclasses.replace(cfg, patch_dropout=0.0)).patch_keep is None


def test_zero_shot_accuracy_matches_jax():
    rng = np.random.default_rng(0)
    img, cls = rng.standard_normal((20, 8)), rng.standard_normal((5, 8))
    labels = rng.integers(0, 5, 20)
    got = CL.zero_shot_accuracy(torch.from_numpy(img), torch.from_numpy(cls),
                                torch.from_numpy(labels))
    assert float(got) == float(JCL.zero_shot_accuracy(jnp.asarray(img), jnp.asarray(cls),
                                                      jnp.asarray(labels)))


def test_clip_train_cli_runs_on_the_cpu():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "clip-vit-huge", "--device", "cpu", "--steps", "2", "--batch", "4",
                          "--quant-mode", "int8_llm"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "final loss:" in out.stdout and "visual.patch_embed" in out.stdout
