"""The port's optimizers, schedules, clipping and loss scalers against the
JAX package's, on identical inputs (seeded numpy), step by step.

Tolerances: both sides compute in f32 with the same operation order, so
most values agree to the last bit or within a few f32 ulps; the
per-tensor means (RMS_t, the global norm) sum in another order. Params,
moments and RMS_t are held to 1e-6 relative to each tensor's max|.|, the
learning rate and the schedules to 1e-6 relative, the scalers' integer
state exactly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JOPT
from repro.optim import loss_scaler as JLS
from repro_torch import optim as TOPT
from repro_torch.models import params as PRM
from repro_torch.optim import loss_scaler as TLS

torch.set_num_threads(1)

TOL = 1e-6


def _tree(rng, scale=1.0):
    """A small param-like tree: matrices (decayed) and vectors (not)."""
    return {"blocks": {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
                       "norm": (rng.standard_normal((5,)) * scale).astype(np.float32)},
            "embed": (rng.standard_normal((7, 3)) * scale).astype(np.float32)}


def _torch(tree):
    return PRM.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, tol=TOL):
    """Every leaf within ``tol`` of max|want| of that leaf."""
    flat_t = dict(PRM.tree_paths(got))
    flat_j = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(flat_t) == set(flat_j)
    for k, t in flat_t.items():
        a = t.double().numpy() if isinstance(t, torch.Tensor) else np.float64(t)
        b = np.asarray(flat_j[k], np.float64)
        if tol == 0.0:                 # exact, Inf and NaN included
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= tol, (k, err)


@pytest.mark.parametrize("name", ["stable_adamw", "adamw"])
def test_optimizer_steps_match_jax(name):
    """Eight steps on identical gradients; at step 5 the gradient jumps
    30x, so StableAdamW's update clipping fires (RMS_t > 1 divides the lr)
    and AdamW's does not exist. Params, both moments, RMS_t and the lr
    are compared after every step."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    sched_t = TOPT.warmup_cosine(1e-2, 3, 8)
    sched_j = JOPT.warmup_cosine(1e-2, 3, 8)
    opt_t = TOPT.make_optimizer(name, sched_t, weight_decay=0.1)
    opt_j = JOPT.make_optimizer(name, sched_j, weight_decay=0.1)
    pt, pj = _torch(params), _jax(params)
    st, sj = opt_t.init(pt), opt_j.init(pj)
    fired = False
    for step in range(8):
        g = _tree(rng, scale=30.0 if step == 5 else 1.0)
        pt, st, aux_t = opt_t.update(pt, st, _torch(g))
        pj, sj, aux_j = opt_j.update(pj, sj, _jax(g))
        _close(pt, pj)
        _close(st.exp_avg, sj.exp_avg)
        _close(st.exp_avg_sq, sj.exp_avg_sq)
        _close(aux_t["rms"], aux_j["rms"])
        assert abs(float(aux_t["lr"]) - float(aux_j["lr"])) <= TOL * abs(float(aux_j["lr"]))
        assert int(st.step) == int(sj.step) == step + 1
        fired |= max(float(v) for v in PRM.tree_leaves(aux_t["rms"])) > 1.0
    assert fired or name == "adamw"


def test_optimizer_skip_mask_keeps_params_and_moments():
    rng = np.random.default_rng(1)
    params, g = _tree(rng), _tree(rng)
    opt_t = TOPT.stable_adamw(1e-2)
    opt_j = JOPT.stable_adamw(1e-2)
    pt, pj = _torch(params), _jax(params)
    st, sj = opt_t.init(pt), opt_j.init(pj)
    skip_t = PRM.tree_map(lambda a: torch.tensor(a.ndim == 1), params)
    skip_j = jax.tree.map(lambda a: jnp.asarray(a.ndim == 1), params)
    pt, st, _ = opt_t.update(pt, st, _torch(g), skip_mask=skip_t)
    pj, sj, _ = opt_j.update(pj, sj, _jax(g), skip_mask=skip_j)
    _close(pt, pj)
    _close(st.exp_avg_sq, sj.exp_avg_sq)
    assert torch.equal(pt["blocks"]["norm"], torch.from_numpy(params["blocks"]["norm"]))


def test_beta_hat_is_computed_in_f32_tensors():
    """β̂_t from the step in f32 tensors, one division, as JAX computes it."""
    from repro_torch.optim.stable_adamw import _beta_hat
    for t in (1, 2, 3, 10, 1000, 12345):
        tf = jnp.asarray(t, jnp.float32)
        want = 0.95 * (1.0 - 0.95 ** (tf - 1.0)) / (1.0 - 0.95 ** tf)
        got = _beta_hat(0.95, torch.tensor(t, dtype=torch.float32))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 2 * np.spacing(np.float32(want))


@pytest.mark.parametrize("which", ["warmup_cosine", "warmup_constant", "beta2_warmup"])
def test_schedules_match_jax(which):
    args = {"warmup_cosine": (2e-3, 50, 400), "warmup_constant": (2e-3, 50),
            "beta2_warmup": (0.5,)}[which]
    st, sj = getattr(TOPT, which)(*args), getattr(JOPT, which)(*args)
    for step in (0, 1, 7, 49, 50, 51, 123, 399, 400, 1000):
        got = float(st(torch.tensor(step, dtype=torch.int32)))
        want = float(sj(jnp.asarray(step, jnp.int32)))
        assert abs(got - want) <= TOL * max(abs(want), 1e-30), (step, got, want)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(np.random.default_rng(2))
    ct, nt = TOPT.clip_by_global_norm(_torch(g), max_norm)
    cj, nj = JOPT.clip_by_global_norm(_jax(g), max_norm)
    assert abs(float(nt) - float(nj)) <= TOL * float(nj)
    _close(ct, cj)


def _bad_grads(rng, bad: bool):
    g = _tree(rng, scale=100.0)
    if bad:
        g["blocks"]["w"][2, 3] = np.inf
    return g


@pytest.mark.parametrize("kind", ["none", "fixed_tensor", "dynamic"])
def test_loss_scalers_match_jax(kind):
    """Three steps, the middle one with an Inf in one tensor: unscaled
    grads, the per-tensor skip mask, the state and the stats."""
    rng = np.random.default_rng(3)
    sc_t, sc_j = TLS.make_scaler(kind), JLS.make_scaler(kind)
    st, sj = sc_t.init(), sc_j.init()
    loss = np.float32(2.5)
    assert float(sc_t.scale(torch.tensor(loss), st)) == float(sc_j.scale(jnp.asarray(loss), sj))
    for bad in (False, True, False):
        g = _bad_grads(rng, bad)
        gt, mt, st, stats_t = sc_t.unscale(_torch(g), st)
        gj, mj, sj, stats_j = sc_j.unscale(_jax(g), sj)
        _close(gt, gj, tol=0.0)
        assert ({k: bool(v) for k, v in PRM.tree_paths(mt)}
                == {jax.tree_util.keystr(p): bool(v)
                    for p, v in jax.tree_util.tree_flatten_with_path(mj)[0]})
        assert float(st.scale) == float(sj.scale) and int(st.good_steps) == int(sj.good_steps)
        assert int(stats_t["n_skipped_tensors"]) == int(stats_j["n_skipped_tensors"])
        assert float(stats_t["loss_scale"]) == float(stats_j["loss_scale"])


def test_adafactor_raises_until_ported():
    with pytest.raises(NotImplementedError):
        TOPT.make_optimizer("adafactor", 1e-3)
    with pytest.raises(ValueError):
        TOPT.make_optimizer("sgd", 1e-3)
