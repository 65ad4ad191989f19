"""The port's training slice against the JAX package's, on the CPU.

The JAX package's parameters (``init_params`` from a PRNG key) are carried
across with ``from_numpy_tree``, and both sides train on the same
``BigramLM`` batches (the port's copy draws the JAX generator's numbers)
with the same ``TrainConfig``: StableAdamW, warmup-cosine lr, no loss
scaling. Two configs: the reduced smollm-360m, whose linears all contract
over at most 2048 (the fused SwitchBack forward and dgrad kernels), and
the same with ``d_ff = 2304``, whose ``w_up``/``w_gate`` dgrad and
``w_down`` forward cross ``FUSED_MAX_CONTRACT`` and take the two-step
paths. Modes ``int8_switchback`` and ``bf16``; ``flash_scan`` (the port's
flash functions, plain versions on the CPU) and ``dense``; one microbatch
and two. The JAX side runs on its ``xla`` backend (dense attention for
both attention settings), jitted with XLA's excess precision off
(ROADMAP.md Queue 3), plus one small case on ``pallas_interpret`` (its
Pallas SwitchBack and flash kernels, interpreted).

Each case compares, side by side:

* the gradient of the first batch, per leaf: max and mean |difference|
  over the leaf's max|JAX gradient| (GRAD_TOL);
* every step's loss (LOSS_TOL, relative) and global gradient norm
  (GNORM_TOL, relative);
* the parameters after the last step, per leaf: mean |difference| over
  the leaf's max (PARAM_MEAN_TOL). Their max is reported, not bounded:
  Adam moves each element by about lr whatever its gradient, so an
  element whose gradient sits near 0 moves by about +-lr on either side
  in a sound run too (measured up to 7.7e-2 of the leaf's max), and a
  wrong gradient moves the mean instead.

The JAX layers round each weight gradient through bf16 on its way to the
f32 master (they cast the master to bf16 before ``quant_linear``); the
port keeps it f32. These cases run the port with that rounding put back
(``jax_weight_rounding``: ``use_weight`` casts through bf16), so both
sides compute the same function; ``test_weight_grads_differ_from_jax_
by_one_bf16_rounding`` bounds the port as it ships against JAX.

Tolerances. On ``pallas_interpret`` both sides run the same attention
algorithm and the gradients agree to 2.6e-4 (max) and 2.7e-8 (mean) of
each leaf's max. On ``xla`` the JAX side runs dense attention where the
port runs its flash functions (or its own dense attention, whose KV-head
expansion sums the group's gradient in bf16 in another order); there the
JAX package's own two backends differ by as much (3.3e-2 / 3.3e-3 on
the int8 case, 1.1e-2 / 9.6e-4 in bf16 under flash_scan), and the port
reads at most 4.4e-2 / 4.1e-3. The int8 quantizers amplify last-bit
differences (an activation on the other side of a rounding boundary
moves its row by one quantization step), and Adam carries them into the
next step's weights. Measured at most: loss 6.3e-4, grad norm 4.5e-3,
parameter mean 5.3e-4.
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
from repro.data import BigramLM as JBigram
from repro.models import build as jax_build
from repro.models.params import init_params as jax_init_params
from repro.train import train_step as JTS
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.data import BigramLM
from repro_torch.models import build
from repro_torch.models import params as PRM
from repro_torch.models.params import from_numpy_tree
from repro_torch.train import (Trainer, init_train_state, loss_and_grads, make_train_setup,
                               make_train_step)

torch.set_num_threads(1)

ARCH = "smollm-360m"
CONFIGS = {"fused": {}, "two_step": {"d_ff": 2304}}
LOSS_TOL = 1e-3
GNORM_TOL = 1e-2
PARAM_MEAN_TOL = 2e-3
# the first batch's gradient per leaf: (max, mean) |diff| / max|JAX|, by
# the JAX side's backend (see the module docstring)
GRAD_TOL = {"xla": (1e-1, 1e-2), "pallas_interpret": (1e-3, 1e-5)}
N_STEPS = 3
# (config, mode, attn_impl, microbatches, JAX backend, batch, seq)
CASES = [
    ("fused", "int8_switchback", "flash_scan", 1, "xla", 4, 16),
    ("fused", "int8_switchback", "dense", 2, "xla", 4, 16),
    ("fused", "bf16", "flash_scan", 2, "xla", 4, 16),
    ("fused", "bf16", "dense", 1, "xla", 4, 16),
    ("two_step", "int8_switchback", "flash_scan", 1, "xla", 4, 16),
    ("two_step", "bf16", "dense", 2, "xla", 4, 16),
    ("fused", "int8_switchback", "flash_scan", 1, "pallas_interpret", 2, 8),
]

_PARAMS: dict = {}


def _setup(which: str):
    if which not in _PARAMS:
        jcfg = dataclasses.replace(jax_reduced(ARCH), **CONFIGS[which])
        tcfg = dataclasses.replace(get_reduced_config(ARCH), **CONFIGS[which])
        jp = jax_init_params(jax_build(jcfg).param_specs, jax.random.PRNGKey(0))
        _PARAMS[which] = (jcfg, tcfg, jp, jax.tree.map(np.asarray, jp))
    return _PARAMS[which]


def _batches(vocab, batch, seq, n):
    """n BigramLM batches from the port's copy, checked against the JAX
    generator's draw for draw."""
    mine, theirs = BigramLM(vocab, temperature=0.2), JBigram(vocab, temperature=0.2)
    out = []
    for _ in range(n):
        a, b = mine.batch(batch, seq), theirs.batch(batch, seq)
        assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))
        out.append(a)
    return out


def _train_cfg(cls, mode, micro, **kw):
    return cls(learning_rate=3e-3, warmup_steps=2, total_steps=N_STEPS, quant_mode=mode,
               microbatch_steps=micro, **kw)


def _flat(tree, prefix=""):
    """{leaf path: float64 array} of a nested dict of torch or JAX arrays."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {prefix: np.asarray(tree, np.float64)}


def _leaf_errs(got: dict, want: dict) -> dict:
    """{leaf path: (max, mean) |got - want| over the leaf's max|want|}."""
    out = {}
    for k, w in want.items():
        d = np.abs(got[k] - w)
        top = np.abs(w).max() or 1.0
        out[k] = (d.max() / top, d.mean() / top)
    return out


def _jax_rounding_use_weight(w, logical=(), dtype=None):
    """``use_weight`` as the JAX layers use it: the master cast to bf16
    before ``quant_linear``, so its gradient is rounded through bf16 on the
    way back (the port passes the master uncast and keeps it f32)."""
    return w.to(torch.bfloat16).to(w.dtype) if dtype is None else w.to(dtype)


def _jax_run(jcfg, jparams, batches, mode, impl, micro, backend):
    """(losses, grad norms, final params, first batch's gradient)."""
    bundle = jax_build(jcfg)
    tc = _train_cfg(JTrain, mode, micro, kernel_backend=backend)
    opt, scaler = JTS.make_train_setup(tc)
    policy = JPolicy(mode, backend=backend)
    parallel = JParallel(mesh_shape=(1, 1), remat="none", attn_impl=impl)
    step = JTS.make_train_step(bundle, policy, parallel, tc, opt, scaler)
    state = JTS.init_train_state(jparams, opt, scaler)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    options = {"xla_allow_excess_precision": False}
    grad_fn = jax.jit(jax.grad(lambda p, b: bundle.loss_fn(p, b, policy, parallel)[0]))
    grad0 = grad_fn.lower(jparams, jb[0]).compile(compiler_options=options)(jparams, jb[0])
    compiled = jax.jit(step).lower(state, jb[0]).compile(compiler_options=options)
    losses, gnorms = [], []
    for b in jb:
        state, metrics = compiled(state, b)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    return losses, gnorms, _flat(state.params), _flat(grad0), metrics


def _port_run(tcfg, np_params, batches, mode, impl, micro):
    """The same as ``_jax_run`` for the port."""
    bundle = build(tcfg)
    tc = _train_cfg(TrainConfig, mode, micro)
    opt, scaler = make_train_setup(tc)
    policy, parallel = QuantPolicy(mode), ParallelConfig(remat="none", attn_impl=impl)
    step = make_train_step(bundle, policy, parallel, tc, opt, scaler)
    params = from_numpy_tree(np_params, device="cpu")
    tb = [{k: torch.from_numpy(v).long() for k, v in b.items()} for b in batches]
    grad0 = loss_and_grads(bundle, policy, parallel, params, tb[0])[0]
    state = init_train_state(params, opt, scaler)
    losses, gnorms = [], []
    for b in tb:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    return losses, gnorms, _flat(state.params), _flat(grad0), metrics


def _keys(tree, prefix=""):
    if isinstance(tree, dict):
        return {k for key, v in tree.items() for k in _keys(v, f"{prefix}/{key}")}
    return {prefix}


@pytest.mark.parametrize("which,mode,impl,micro,backend,batch,seq", CASES,
                         ids=["-".join(map(str, c[:5])) for c in CASES])
def test_training_matches_jax(monkeypatch, which, mode, impl, micro, backend, batch, seq):
    jcfg, tcfg, jparams, np_params = _setup(which)
    batches = _batches(tcfg.vocab_size, batch, seq, N_STEPS)
    j_loss, j_gnorm, j_params, j_grad, j_metrics = _jax_run(jcfg, jparams, batches, mode,
                                                            impl, micro, backend)
    monkeypatch.setattr(PRM, "use_weight", _jax_rounding_use_weight)
    t_loss, t_gnorm, t_params, t_grad, t_metrics = _port_run(tcfg, np_params, batches, mode,
                                                             impl, micro)
    assert all(np.isfinite(t_loss))
    grad = _leaf_errs(t_grad, j_grad)
    tol = GRAD_TOL[backend]
    bad = {k: e for k, e in grad.items() if e[0] > tol[0] or e[1] > tol[1]}
    assert not bad, ("first batch's gradient", bad, tol)
    rel = [abs(a - b) / abs(b) for a, b in zip(t_loss, j_loss)]
    assert max(rel) <= LOSS_TOL, (t_loss, j_loss, rel)
    rel = [abs(a - b) / abs(b) for a, b in zip(t_gnorm, j_gnorm)]
    assert max(rel) <= GNORM_TOL, (t_gnorm, j_gnorm, rel)
    params = _leaf_errs(t_params, j_params)
    bad = {k: e for k, e in params.items() if e[1] > PARAM_MEAN_TOL}
    assert not bad, ("final parameters (max, mean)", bad, PARAM_MEAN_TOL)
    assert _keys(t_metrics) == _keys(jax.tree.map(np.asarray, j_metrics))


@pytest.mark.parametrize("mode", ["int8_switchback", "bf16"])
def test_weight_grads_differ_from_jax_by_one_bf16_rounding(mode):
    """The port as it ships against the JAX package, where they differ on
    purpose: the JAX layers round every linear's weight gradient through
    bf16 (its values lie on the bf16 grid), the port keeps it f32. Rounded
    through bf16, the port's weight gradients come within the
    pallas_interpret GRAD_TOL of JAX's; unrounded they lie outside it. The
    other leaves (embedding, norms) agree within that tolerance as they
    are. Both sides run the same attention algorithm (JAX on its Pallas
    kernels, interpreted)."""
    jcfg, tcfg, jparams, np_params = _setup("fused")
    batch = _batches(tcfg.vocab_size, 2, 8, 1)[0]
    policy = JPolicy(mode, backend="pallas_interpret")
    parallel = JParallel(mesh_shape=(1, 1), remat="none", attn_impl="flash_scan")
    bundle = jax_build(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_grad = _flat(jax.jit(jax.grad(lambda p, b: bundle.loss_fn(p, b, policy, parallel)[0]))
                   .lower(jparams, jb).compile(
                       compiler_options={"xla_allow_excess_precision": False})(jparams, jb))
    t_grad = _flat(loss_and_grads(build(tcfg), QuantPolicy(mode),
                                  ParallelConfig(remat="none", attn_impl="flash_scan"),
                                  from_numpy_tree(np_params, device="cpu"),
                                  {k: torch.from_numpy(v).long() for k, v in batch.items()})[0])
    tol = GRAD_TOL["pallas_interpret"]
    linear = [k for k in j_grad if "/attn/w" in k or "/mlp/w" in k]
    assert len(linear) == 7
    bf16 = {k: torch.from_numpy(t_grad[k]).bfloat16().double().numpy() for k in linear}
    for k in linear:
        np.testing.assert_array_equal(
            j_grad[k], torch.from_numpy(j_grad[k]).bfloat16().double().numpy(), err_msg=k)
        assert np.mean(bf16[k] != t_grad[k]) > 0.9, k          # the port's are f32
    rounded = _leaf_errs({**t_grad, **bf16}, j_grad)
    assert all(e[0] <= tol[0] and e[1] <= tol[1] for e in rounded.values()), (rounded, tol)
    shipped = _leaf_errs(t_grad, j_grad)
    assert all(shipped[k][0] > tol[0] or shipped[k][1] > tol[1] for k in linear), (shipped, tol)


def test_configs_cover_both_dgrad_paths():
    from repro_torch.kernels.switchback.ops import FUSED_MAX_CONTRACT
    assert _setup("fused")[1].d_ff <= FUSED_MAX_CONTRACT < _setup("two_step")[1].d_ff


def test_trainer_runs_and_reports():
    """``Trainer.run`` over the port's step: history, the flush's one
    fetch of every metric, the RMS monitor on the embedding, the report."""
    _, tcfg, _, np_params = _setup("fused")
    tc = _train_cfg(TrainConfig, "int8_switchback", 1)
    opt, scaler = make_train_setup(tc)
    step = make_train_step(build(tcfg), QuantPolicy("int8_switchback"),
                           ParallelConfig(remat="none"), tc, opt, scaler)
    seen = []
    trainer = Trainer(step, init_train_state(from_numpy_tree(np_params, device="cpu"), opt, scaler),
                      log_every=2)
    trainer.hooks.on_step = lambda i, rec: seen.append(i)
    batches = _batches(tcfg.vocab_size, 2, 8, N_STEPS)
    hist = trainer.run(lambda i: {k: torch.from_numpy(v).long() for k, v in batches[i].items()},
                       N_STEPS)
    assert [h["step"] for h in hist] == seen == list(range(N_STEPS))
    assert all(np.isfinite(h["loss"]) and h["n_skipped"] == 0 for h in hist)
    assert int(trainer.state.step) == N_STEPS
    report = trainer.stability_report()
    assert report["loss_spike_steps"] == [] and "embed" in report
    assert any("embed" in k for k in trainer.rms_monitor.layers())


def test_train_cli_runs_on_the_cpu():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--steps", "2", "--batch", "2", "--seq", "16",
                          "--quant-mode", "int8_switchback"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "final loss:" in out.stdout and "stability:" in out.stdout
