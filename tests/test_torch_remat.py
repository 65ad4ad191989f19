"""Activation recomputation (``remat="block"``/``"full"``) in the port, on
the CPU.

Recomputation changes what is kept for the backward, not what is computed:
the port's steps under ``"block"`` and ``"full"`` (the same function, as in
the JAX package) give ``"none"``'s losses, gradients, metrics and
parameters bit for bit, for the reduced CLIP (each block of both towers
recomputed, the per-block stats out of the recomputed body) and smollm
(each layer group), on the flash path (the kernels' plain versions here)
and in an int8 mode. The port under ``"block"`` is held to the JAX package
under ``"block"`` with ``tests/test_torch_clip.py``'s tolerances. The
train CLI runs with ``"block"``, as the JAX CLI does.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.core.precision import QuantPolicy as JPolicy
from repro.models import build as jax_build
from repro.train import train_step as JTS
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.data import BigramLM
from repro_torch.models import build
from repro_torch.models import params as PRM
from repro_torch.models.params import from_numpy_tree
from repro_torch.models.transformer import maybe_remat
from repro_torch.train import init_train_state, loss_and_grads, make_train_setup, make_train_step

import test_torch_clip as TCLIP

torch.set_num_threads(1)

N_STEPS = 3
KEYS = ("loss", "grad_norm", "contrastive_acc", "feature_stats", "n_skipped_tensors")


def _clip_run(remat, mode="int8_switchback", lsi=0.0):
    jcfg, tcfg, _, np_params = TCLIP._setup(lsi)
    batches = TCLIP._batches(tcfg, N_STEPS)
    keeps = TCLIP._jax_patch_keeps(jcfg, N_STEPS)
    tc = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=N_STEPS, quant_mode=mode)
    opt, scaler = make_train_setup(tc)
    step = make_train_step(TCLIP._port_bundle(tcfg, keeps), QuantPolicy(mode),
                           ParallelConfig(remat=remat), tc, opt, scaler)
    state = init_train_state(from_numpy_tree(np_params, device="cpu"), opt, scaler)
    hist = []
    for b in batches:
        state, m = step(state, {"images": torch.from_numpy(b["images"]),
                                "texts": torch.from_numpy(b["texts"]).long()})
        hist.append({k: m[k] for k in KEYS})
    return hist, state


def _same_tree(a, b):
    pa, pb = dict(PRM.tree_paths(a)), dict(PRM.tree_paths(b))
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


@pytest.mark.parametrize("remat", ["block", "full"])
def test_clip_remat_is_bit_equal_to_none(remat):
    base_hist, base = _clip_run("none")
    hist, state = _clip_run(remat)
    for h, g in zip(hist, base_hist):
        for k in KEYS:
            assert torch.equal(h[k], g[k]), k
    _same_tree(state.params, base.params)
    _same_tree(state.opt_state.exp_avg_sq, base.opt_state.exp_avg_sq)


def test_clip_stats_and_gradients_under_remat():
    """One batch's loss, per-block stats (``collect_stats``) and gradient,
    with and without recomputation: the same bits."""
    _, tcfg, _, np_params = TCLIP._setup(None)
    batch = TCLIP._batches(tcfg, 1)[0]
    b = {"images": torch.from_numpy(batch["images"]), "texts": torch.from_numpy(batch["texts"])}
    keep = torch.arange(8)                      # 8 of the reduced CLIP's 16 patches
    out = {}
    for remat in ("none", "block"):
        out[remat] = loss_and_grads(build(tcfg), QuantPolicy("bf16"), ParallelConfig(remat=remat),
                                    from_numpy_tree(np_params, device="cpu"), b,
                                    patch_keep=keep, collect_stats=True)
    (g0, l0, m0), (g1, l1, m1) = out["none"], out["block"]
    assert torch.equal(l0, l1) and torch.equal(m0["feature_stats"], m1["feature_stats"])
    assert m1["feature_stats"].shape == (tcfg.vision_layers,)
    assert bool((m1["feature_stats"] > 0).all())
    _same_tree(g0, g1)


def _smollm_run(remat, mode):
    cfg = get_reduced_config("smollm-360m")
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=N_STEPS, quant_mode=mode)
    opt, scaler = make_train_setup(tc)
    step = make_train_step(build(cfg), QuantPolicy(mode), ParallelConfig(remat=remat), tc,
                           opt, scaler)
    state = init_train_state(PRM.init_params(build(cfg).param_specs, 0, device="cpu"), opt,
                             scaler)
    data = BigramLM(cfg.vocab_size, temperature=0.2)
    losses = []
    for _ in range(N_STEPS):
        batch = {k: torch.from_numpy(v).long() for k, v in data.batch(4, 16).items()}
        state, m = step(state, batch)
        losses.append(m["loss"])
    return losses, state


@pytest.mark.parametrize("mode", ["int8_switchback", "bf16"])
def test_smollm_remat_is_bit_equal_to_none(mode):
    l0, s0 = _smollm_run("none", mode)
    l1, s1 = _smollm_run("block", mode)
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    _same_tree(s1.params, s0.params)


def test_remat_keeps_the_rng_state():
    """A body that draws random numbers recomputes with the same draws
    (the RNG state is saved with the inputs), so its gradient is the
    un-recomputed one's."""
    x = torch.randn(6, 5)
    grads = {}
    for remat in ("none", "block"):
        xx = x.clone().requires_grad_()
        torch.manual_seed(3)
        fn = maybe_remat(lambda t: (t * torch.rand(t.shape)).sin(), ParallelConfig(remat=remat))
        grads[remat] = torch.autograd.grad(fn(xx).sum(), xx)[0]
    assert torch.equal(grads["none"], grads["block"])


def test_clip_remat_block_matches_jax_remat_block():
    """The port under ``"block"`` against the JAX package under ``"block"``
    (``jax.checkpoint`` of each block), 3 steps, int8_switchback with
    zero-init layer-scale: ``tests/test_torch_clip.py``'s tolerances."""
    mode = "int8_switchback"
    jcfg, tcfg, jparams, np_params = TCLIP._setup(0.0)
    batches = TCLIP._batches(tcfg, N_STEPS)
    tc = TCLIP._train_cfg(JTrain, mode)
    opt, scaler = JTS.make_train_setup(tc)
    step = JTS.make_train_step(jax_build(jcfg), JPolicy(mode),
                               JParallel(mesh_shape=(1, 1), remat="block"), tc, opt, scaler)
    state = JTS.init_train_state(jparams, opt, scaler)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    compiled = jax.jit(step).lower(state, jb[0]).compile(compiler_options=TCLIP.XLA)
    j_loss = []
    for b in jb:
        state, m = compiled(state, b)
        j_loss.append(float(m["loss"]))
    hist, tstate = _clip_run("block")
    for i, (h, jl) in enumerate(zip(hist, j_loss)):
        tol = TCLIP.LOSS0_TOL if i == 0 else TCLIP.LOSS_TOL
        assert abs(float(h["loss"]) - jl) <= tol * abs(jl), (i, float(h["loss"]), jl)
    p0, t_params, j_params = (TCLIP._flat(np_params), TCLIP._flat(tstate.params),
                              TCLIP._flat(state.params))
    errs = TCLIP._leaf_errs({k: t_params[k] - p0[k] for k in p0},
                            {k: j_params[k] - p0[k] for k in p0})
    bad = {k: e for k, e in errs.items()
           if e[1] > TCLIP.DELTA_MEAN_TOL and not k.endswith("/bk")}
    assert not bad, ("each leaf's change over the steps (max, mean)", bad)


def test_train_cli_trains_with_block_remat(monkeypatch):
    """``launch/train.py`` builds its step with ``remat="block"``, the JAX
    CLI's choice."""
    from repro_torch.launch import train
    from repro_torch.train import engine
    seen = []
    real = engine.make_train_step

    def spy(bundle, policy, parallel, *a, **kw):
        seen.append(parallel.remat)
        return real(bundle, policy, parallel, *a, **kw)

    # the launcher trains through the engine, which builds the step
    monkeypatch.setattr(engine, "make_train_step", spy)
    train.main(["--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "8"])
    assert seen == ["block"]


def test_serve_engine_keeps_remat_none():
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve import make_serve_engine
    eng = make_serve_engine(build(get_reduced_config("smollm-360m")),
                            ServeConfig(max_batch=1, max_len=8), device="cpu")
    assert eng.parallel.remat == "none"
