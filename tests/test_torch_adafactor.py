"""The port's AdaFactor against the JAX package's, on the CPU.

The update is held to the reference's ``update(skip_mask=None)`` step by
step on a tree with stacked (L, n, m) matrices, vectors and a 0-d leaf,
with and without the first moment: params and moments within 1e-6 of each
leaf's max (a few f32 ulps: ``torch.mean`` sums in another order than
XLA's, and torch's ``pow`` rounds t^(-0.8) one ulp off XLA's at t = 4).

No JAX train step can run AdaFactor: the reference's ``apply_skip_mask``
maps ``jnp.where`` over the per-leaf moment dicts and raises, and every
loss scaler returns a skip mask (ROADMAP.md Queue 3). So the port's train
step is held against the update the reference can run, fed by JAX's own
``clip_loss`` gradient (the step without the skip mask), and the port's
skip mask is pinned on its own: a skipped tensor keeps its parameter and
every tensor of its moment dict (Queue 3 #4), the others take the
unmasked update bit for bit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JOPT
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.core.precision import QuantPolicy as JPolicy
from repro.models import clip as JCL
from repro.optim.base import apply_skip_mask as j_apply_skip_mask
from repro.train import train_step as JTS
from repro_torch import optim as TOPT
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.models import params as PRM
from repro_torch.models.params import from_numpy_tree
from repro_torch.train import init_train_state, make_train_setup, make_train_step

from test_torch_clip import (XLA, _batches, _flat, _jax_patch_keeps, _leaf_errs,
                             _port_bundle, _setup)

torch.set_num_threads(1)

TOL = 1e-6
N_STEPS = 2
# the CLIP step's tolerances (tests/test_torch_clip.py: the port's flash
# attention and int8 kernels' plain versions against JAX's xla backend)
LOSS0_TOL, LOSS_TOL, GNORM_TOL, DELTA_MEAN_TOL = 2e-3, 3e-2, 3e-2, 5e-2


def _tree(rng):
    return {"blocks": {"w": rng.standard_normal((3, 6, 5)).astype(np.float32),
                       "norm": rng.standard_normal((3, 5)).astype(np.float32)},
            "embed": rng.standard_normal((7, 3)).astype(np.float32),
            "bias": rng.standard_normal((4,)).astype(np.float32),
            "logit_scale": np.full((), 0.7, np.float32)}


def _torch(tree):
    return PRM.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _flat_t(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat_t(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree,
                               np.float64)}


def _close(got: dict, want: dict, tol=TOL):
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (k, err)


@pytest.mark.parametrize("beta1", [None, 0.9])
def test_update_matches_jax(beta1):
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    jo = JOPT.adafactor(JOPT.warmup_cosine(1e-2, 2, 10), beta1=beta1)
    to = TOPT.adafactor(TOPT.warmup_cosine(1e-2, 2, 10), beta1=beta1)
    jp, tp = jax.tree.map(jnp.asarray, tree), _torch(tree)
    js, ts = jo.init(jp), to.init(tp)
    assert _flat_t(ts.moments).keys() == _flat_t(jax.tree.map(np.asarray, js.moments)).keys()
    for _ in range(5):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32), tree)
        jp, js, jaux = jo.update(jp, js, jax.tree.map(jnp.asarray, g))
        tp, ts, taux = to.update(tp, ts, _torch(g))
        _close(_flat_t(tp), _flat_t(jax.tree.map(np.asarray, jp)))
        _close(_flat_t(ts.moments), _flat_t(jax.tree.map(np.asarray, js.moments)))
        assert int(ts.step) == int(js.step) and float(taux["lr"]) == float(jaux["lr"])


def test_skip_mask_keeps_the_tensor_and_its_moments():
    """A skipped tensor keeps its parameter and every tensor of its moment
    dict; the others take the unmasked update bit for bit. The reference
    raises here instead (pinned: the caveat this difference answers)."""
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    to = TOPT.adafactor(1e-2, beta1=0.9)
    tp = _torch(tree)
    st = to.init(tp)
    g = _torch(jax.tree.map(lambda a: (rng.standard_normal(a.shape)).astype(np.float32), tree))
    tp, st, _ = to.update(tp, st, g)                  # non-zero moments first
    free, _, _ = to.update(tp, st, g)
    free_st = to.update(tp, st, g)[1]
    skip = PRM.tree_map(lambda p: torch.tensor(False), tp)
    skip["blocks"]["w"] = torch.tensor(True)
    skip["logit_scale"] = torch.tensor(True)
    masked, mst, _ = to.update(tp, st, g, skip_mask=skip)
    for path, s in PRM.tree_paths(skip):
        want_p = dict(PRM.tree_paths(tp if bool(s) else free))[path]
        assert torch.equal(dict(PRM.tree_paths(masked))[path], want_p), path
    for key in ("vr", "vc", "m"):
        assert torch.equal(mst.moments["blocks"]["w"][key], st.moments["blocks"]["w"][key])
    for key in ("v", "m"):
        assert torch.equal(mst.moments["logit_scale"][key], st.moments["logit_scale"][key])
        assert torch.equal(mst.moments["bias"][key], free_st.moments["bias"][key])
    assert int(mst.step) == int(st.step) + 1
    # the reference's apply_skip_mask cannot take AdaFactor's moment dicts
    jmom = jax.tree.map(jnp.asarray, {"w": {"vr": np.zeros(2, np.float32),
                                            "vc": np.zeros(3, np.float32)}})
    with pytest.raises(TypeError):
        j_apply_skip_mask({"w": jnp.asarray(True)}, jmom, jmom)


def test_factored_state_is_rows_plus_columns():
    """The factored second moment keeps n + m values a matrix, L (n + m) a
    stacked (L, n, m) leaf (the reference's test_adafactor_factored_memory)."""
    to = TOPT.adafactor(0.01)
    st = to.init({"w": torch.zeros(64, 32), "stack": torch.zeros(3, 64, 32),
                  "b": torch.zeros(32)})
    n = sum(t.numel() for t in PRM.tree_leaves(st.moments))
    assert n == (64 + 32) + 3 * (64 + 32) + 32
    assert st.moments["stack"]["vr"].shape == (3, 64) and st.moments["stack"]["vc"].shape == (3, 32)


def test_converges_on_a_quadratic():
    """The reference's test_adafactor_converges, on the port."""
    target = torch.from_numpy(np.random.default_rng(2).standard_normal((16, 8)).astype(np.float32))
    opt = TOPT.make_optimizer("adafactor", 0.05, weight_decay=0.0)
    p = {"w": torch.zeros(16, 8)}
    st = opt.init(p)
    for _ in range(500):
        p, st, _ = opt.update(p, st, {"w": p["w"] - target})
    assert float(0.5 * torch.sum((p["w"] - target) ** 2)) < 2e-2


def test_make_train_setup_takes_the_reference_branch():
    """Only the schedule and weight_decay reach AdaFactor, as in the
    reference: beta1 and beta2 of the TrainConfig are not passed."""
    tc = TrainConfig(optimizer="adafactor", beta1=0.5, beta2=0.5, weight_decay=0.0,
                     learning_rate=1e-2, warmup_steps=1, total_steps=4)
    opt, _ = make_train_setup(tc)
    st = opt.init({"w": torch.zeros(4, 3)})
    assert set(st.moments["w"]) == {"vr", "vc"}           # no first moment
    jopt, _ = JTS.make_train_setup(
        JTrain(optimizer="adafactor", beta1=0.5, beta2=0.5, weight_decay=0.0,
               learning_rate=1e-2, warmup_steps=1, total_steps=4))
    g = np.random.default_rng(3).standard_normal((4, 3)).astype(np.float32)
    p0 = np.random.default_rng(4).standard_normal((4, 3)).astype(np.float32)
    tp, _, _ = opt.update({"w": torch.from_numpy(p0.copy())}, st, {"w": torch.from_numpy(g)})
    jp, _, _ = jopt.update({"w": jnp.asarray(p0)}, jopt.init({"w": jnp.asarray(p0)}),
                           {"w": jnp.asarray(g)})
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=0, atol=1e-6)


def _jax_adafactor_run(jcfg, jparams, batches, mode):
    """The reference's train step for AdaFactor without the skip mask:
    JAX's clip_loss gradient, the no-op scaler's unscale, the update."""
    tc = JTrain(learning_rate=3e-4, warmup_steps=2, total_steps=N_STEPS, quant_mode=mode,
                optimizer="adafactor")
    opt, scaler = JTS.make_train_setup(tc)
    policy, parallel = JPolicy(mode), JParallel(mesh_shape=(1, 1), remat="none")

    def step(params, opt_state, rng, batch):
        rng, sub = jax.random.split(rng)
        (loss, _), grads = jax.value_and_grad(
            lambda p: JCL.clip_loss(p, batch, jcfg, policy, parallel, patch_drop_rng=sub),
            has_aux=True)(params)
        grads, _, _, _ = scaler.unscale(grads, scaler.init())
        gnorm = JOPT.global_norm(grads)
        params, opt_state, _ = opt.update(params, opt_state, grads, skip_mask=None)
        return params, opt_state, rng, loss, gnorm

    params, opt_state, rng = jparams, opt.init(jparams), jax.random.PRNGKey(0)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    compiled = jax.jit(step).lower(params, opt_state, rng, jb[0]).compile(
        compiler_options=XLA)
    hist = []
    for b in jb:
        params, opt_state, rng, loss, gnorm = compiled(params, opt_state, rng, b)
        hist.append((float(loss), float(gnorm)))
    return hist, _flat(params)


def test_clip_train_step_matches_the_reference_update():
    """The port's CLIP train step (int8_switchback, zero-init layer-scale,
    AdaFactor) against JAX's gradient and the reference's update, 2 steps."""
    mode = "int8_switchback"
    jcfg, tcfg, jparams, np_params = _setup(0.0)
    batches = _batches(tcfg, N_STEPS)
    keeps = _jax_patch_keeps(jcfg, N_STEPS)
    j_hist, j_params = _jax_adafactor_run(jcfg, jparams, batches, mode)
    tc = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=N_STEPS, quant_mode=mode,
                     optimizer="adafactor")
    opt, scaler = make_train_setup(tc)
    step = make_train_step(_port_bundle(tcfg, keeps), QuantPolicy(mode),
                           ParallelConfig(remat="none"), tc, opt, scaler)
    state = init_train_state(from_numpy_tree(np_params, device="cpu"), opt, scaler)
    for i, b in enumerate(batches):
        state, m = step(state, {"images": torch.from_numpy(b["images"]),
                                "texts": torch.from_numpy(b["texts"]).long()})
        jl, jg = j_hist[i]
        tol = LOSS0_TOL if i == 0 else LOSS_TOL
        assert abs(float(m["loss"]) - jl) <= tol * abs(jl), (i, float(m["loss"]), jl)
        assert abs(float(m["grad_norm"]) - jg) <= GNORM_TOL * jg, (i, float(m["grad_norm"]), jg)
        assert int(m["n_skipped_tensors"]) == 0
    p0, t_params = _flat(np_params), _flat(state.params)
    errs = _leaf_errs({k: t_params[k] - p0[k] for k in p0}, {k: j_params[k] - p0[k] for k in p0})
    bad = {k: e for k, e in errs.items() if e[1] > DELTA_MEAN_TOL and not k.endswith("/bk")}
    assert not bad, ("each leaf's change over the steps (max, mean)", bad, DELTA_MEAN_TOL)


def test_adafactor_state_round_trips_a_checkpoint(tmp_path):
    rng = np.random.default_rng(5)
    tree = _torch(_tree(rng))
    opt = TOPT.adafactor(1e-2, beta1=0.9)
    st = opt.init(tree)
    tree, st, _ = opt.update(tree, st, _torch(_tree(rng)))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": tree, "opt": st})
    back, step, _ = mgr.restore(1, like={"params": tree, "opt": st}, device="cpu")
    assert step == 1 and type(back["opt"]).__name__ == "AdafactorState"
    want, got = _flat_t(st.moments), _flat_t(back["opt"].moments)
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    assert torch.equal(back["opt"].step, st.step)
    for (_, a), (_, b) in zip(PRM.tree_paths(tree), PRM.tree_paths(back["params"])):
        assert torch.equal(a, b)
