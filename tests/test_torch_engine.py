"""The port's sharded TrainEngine on the data axes, on the CPU: gloo
groups of 1, 2 and 4 ranks spawned by the tests (``torch_ranks.py``),
held to the JAX engine on a (1, 1) mesh and to the port's own world 1.

* Parity. Each case trains STEPS steps of a reduced config from the JAX
  engine's initial parameters on the same batches (BigramLM; SyntheticCLIP
  with JAX's kept patches fed in): ``fsdp`` on (2, 1) and (4, 1),
  ``pure_dp`` with ``fsdp`` on (2, 2), plain data parallelism, two
  microbatches, the explicit weight gather, AdaFactor, the reduced CLIP
  with patch dropout on (2, 1) and (2, 2), ``int8_switchback``, and the
  int8 wire. Every step's loss and grad norm are held to the JAX engine's
  (the JAX engine tests' policy, ``QuantPolicy("bf16", compute_dtype=f32)``,
  and their cross-mesh tolerance, JAX_TOL) and to the port's world 1 (the
  same case on a (1, 1) mesh; SELF_TOL), and the final parameters,
  gathered whole, to world 1's (PARAM_TOL). AdaFactor and the int8 wire
  have no JAX run to be held to (ROADMAP.md Queue 3 #5: no JAX train step
  runs AdaFactor, and the reference's int8 wire freezes the weights).
* At world 1 the engine adds no arithmetic: without fsdp, and with fsdp,
  the explicit gather and pure_dp, the losses and parameters of the direct
  ``make_train_step`` bit for bit; with the int8 wire, those of the direct
  step whose weights pass through ``models.params.int8_wire``, and not
  those of the control fault (an absmax per half of the weight).
* Edges: a world-2 run checkpointed, dropped and resumed equals the
  uninterrupted run bit for bit; its checkpoint restores at world 1 bit
  for bit, and the other way round, with the crcs of a world-1 run; the
  supervisor recovers from an injected NaN on the sharded engine; the
  int8 wire's gradient is straight-through, where the reference's is zero
  off the absmax element; a ``model`` axis above 1 without ``pure_dp``
  raises, citing ROADMAP.md Queue 1 #13; the CLI trains 4 ranks.

Tolerances. The sum over ranks changes only the rounding: each rank's
weight gradient is summed in f32 rank by rank, and a mean over a split
dim is one all-reduced sum. Measured at world 2 and 4 against world 1,
under the f32-compute policy: loss and grad norm within 3.4e-7
(relative), against the JAX engine within 1e-6. Under ``int8_switchback``
the int8 quantizers turn last-bit differences into quantization steps
(``tests/test_torch_train.py``): loss 8.2e-5, grad norm 4.2e-3 against
world 1; the port's int8 tolerance against the JAX package holds both.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as TR
from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.core.precision import QuantPolicy as JPolicy
from repro.launch.mesh import make_test_mesh as jax_mesh
from repro.models import build as jax_build
from repro.models import params as JP
from repro.train import make_engine as jax_engine
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.data import BigramLM, SyntheticCLIP
from repro_torch.models import build
from repro_torch.models import params as PRM
from repro_torch.train.engine import require_data_axes

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
BATCH, SEQ = 8, 16
JAX_TOL = 5e-3                # tests/test_engine.py's cross-mesh rtol
SELF_TOL = 1e-5               # world 2 and 4 against world 1 (f32 compute)
PARAM_TOL = 1e-5              # final parameters: mean |diff| over the leaf's max
INT8_TOL = (1e-3, 1e-2)       # loss, grad norm (tests/test_torch_train.py)
INT8_PARAM_TOL = 2e-3

FSDP = (("fsdp", True),)
PURE = FSDP + (("pure_dp", True),)
GATHER = FSDP + (("fsdp_gather_weights", True),)
WIRE = PURE + (("fsdp_gather_weights", True), ("gather_wire", "int8"))
CASES = {
    "fsdp-2x1": TR.Case("smollm-360m", (2, 1), FSDP),
    "fsdp-4x1": TR.Case("smollm-360m", (4, 1), FSDP),
    "pure_dp-fsdp-2x2": TR.Case("smollm-360m", (2, 2), PURE),
    "dp-2x1": TR.Case("smollm-360m", (2, 1)),
    "microbatch2-fsdp-2x1": TR.Case("smollm-360m", (2, 1), FSDP, micro=2),
    "gather-fsdp-2x1": TR.Case("smollm-360m", (2, 1), GATHER),
    "adafactor-fsdp-2x1": TR.Case("smollm-360m", (2, 1), FSDP, optimizer="adafactor"),
    "clip-fsdp-2x1": TR.Case("clip-vit-huge", (2, 1), FSDP),
    "clip-pure_dp-fsdp-2x2": TR.Case("clip-vit-huge", (2, 2), PURE),
    "int8-fsdp-2x1": TR.Case("smollm-360m", (2, 1), FSDP, mode="int8_switchback"),
    "int8_wire-pure_dp-2x2": TR.Case("smollm-360m", (2, 2), WIRE, mode="int8_switchback"),
}
NO_JAX = ("adafactor-fsdp-2x1", "int8_wire-pure_dp-2x2")


def _world(shape) -> int:
    return shape[0] * shape[1]


def _specs(arch):
    return build(get_reduced_config(arch)).param_specs


# ---------------------------------------------------------------------------
# inputs and the JAX engine
# ---------------------------------------------------------------------------

def _batches(arch):
    cfg = get_reduced_config(arch)
    if arch == "clip-vit-huge":
        d = SyntheticCLIP(cfg.image_size, cfg.text_ctx, cfg.text_vocab, n_classes=32)
        return [{"images": b["images"], "texts": b["texts"]}
                for b in (d.batch(BATCH) for _ in range(STEPS))]
    return [BigramLM(cfg.vocab_size, seed=1000 + i, temperature=0.3).batch(BATCH, SEQ)
            for i in range(STEPS)]


def _jax_patch_keeps(cfg, n, seed=0):
    """The kept patches of the JAX engine's first ``n`` steps (one
    microbatch): its step splits the state's key and permutes the patches
    with the subkey."""
    rng, out = jax.random.PRNGKey(seed), []
    keep = max(1, int(cfg.n_patches * (1 - cfg.patch_dropout)))
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.permutation(sub, cfg.n_patches)[:keep]))
    return out


def _jax_run(case: TR.Case, batches):
    """The JAX engine on a (1, 1) mesh: its initial parameters (numpy) and
    its trajectory; None for a case the JAX train step cannot run."""
    cfg = jax_reduced(case.arch)
    tc = JTrain(optimizer=case.optimizer, learning_rate=1e-3, warmup_steps=2, total_steps=100,
                loss_scaler="none", quant_mode=case.mode, microbatch_steps=case.micro)
    pol = (JPolicy("bf16", compute_dtype=jnp.float32) if case.mode == "bf16"
           else JPolicy(case.mode))
    mesh = jax_mesh((1, 1))
    par = JParallel(mesh_shape=(1, 1), mesh_axes=("data", "model"), remat="block")
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    eng = jax_engine(jax_build(cfg), tc, par, mesh, jb[0], policy=pol)
    state = eng.init_state(0)
    params = jax.tree.map(np.asarray, state.params)
    if case.optimizer == "adafactor":          # ROADMAP.md Queue 3 #5
        return params, None
    hist = []
    for b in jb:
        state, m = eng.step(state, eng.shard_batch(b))
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return params, hist


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Every case at its world and at world 1 (three spawned groups), and
    the JAX engine's run of each (arch, optimizer, microbatches, mode)."""
    tmp = tmp_path_factory.mktemp("parity")
    inputs, jax_hist = {}, {}
    for name, case in CASES.items():
        key = (case.arch, case.optimizer, case.micro, case.mode)
        if key not in inputs:
            batches = _batches(case.arch)
            params, hist = _jax_run(case, batches)
            keeps = (_jax_patch_keeps(jax_reduced(case.arch), STEPS)
                     if case.arch == "clip-vit-huge" else None)
            inputs[key] = (params, batches, keeps)
            jax_hist[key] = hist
    jobs = {}
    for name, case in CASES.items():
        params, batches, keeps = inputs[(case.arch, case.optimizer, case.micro, case.mode)]
        for c in (case, case.at((1, 1))):
            jobs.setdefault(_world(c.shape), {})[c] = (c, params, batches, keeps)
    results = {}
    for world, by_case in sorted(jobs.items()):
        ranks = TR.run_ranks(world, TR.engine_runs, (list(by_case.values()),), tmp)
        for r in ranks[1:]:                  # every rank reports the same
            for (h0, _), (h, _) in zip(ranks[0], r):
                assert h == h0
        results.update(zip(by_case, ranks[0]))
    return {name: dict(got=results[case], one=results[case.at((1, 1))],
                       jax=jax_hist[(case.arch, case.optimizer, case.micro, case.mode)])
            for name, case in CASES.items()}


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)) / np.abs(np.asarray(want))


def _param_errs(got, want) -> dict:
    """Per leaf, mean |difference| over the leaf's max |value|; CLIP's key
    bias left out: its exact gradient is 0 (softmax ignores a per-query
    constant), so both runs hold rounding noise there, which Adam turns
    into +-lr steps (tests/test_torch_clip.py)."""
    out = {}
    for (path, g), (_, w) in zip(PRM.tree_paths(got), PRM.tree_paths(want)):
        if path.endswith("['bk']"):
            continue
        top = float(np.abs(w).max()) or 1.0
        out[path] = float(np.abs(g.astype(np.float64) - w).mean()) / top
    return out


@pytest.mark.parametrize("name", CASES)
def test_sharded_engine_matches_jax_and_world_one(name, parity):
    r = parity[name]
    (hist, params), (hist1, params1) = r["got"], r["one"]
    int8 = CASES[name].mode != "bf16"
    loss_tol, gnorm_tol = INT8_TOL if int8 else (SELF_TOL, SELF_TOL)
    rel = _rel(hist, hist1)
    assert rel[:, 0].max() <= loss_tol and rel[:, 1].max() <= gnorm_tol, (hist, hist1)
    errs = _param_errs(params, params1)
    assert max(errs.values()) <= (INT8_PARAM_TOL if int8 else PARAM_TOL), errs
    if name in NO_JAX:
        return
    jtol = INT8_TOL if int8 else (JAX_TOL, JAX_TOL)
    for h in (hist, hist1):
        rel = _rel(h, r["jax"])
        assert rel[:, 0].max() <= jtol[0] and rel[:, 1].max() <= jtol[1], (h, r["jax"])


def test_world_one_engine_adds_no_arithmetic(tmp_path):
    """chip_smoke.py phase 31 (a)-(c) on the CPU: the engine at world 1
    against the direct step, bit for bit."""
    case = TR.Case("smollm-360m", (1, 1), mode="int8_switchback")
    params = PRM.tree_map(lambda t: t.numpy(), PRM.init_params(_specs(case.arch), 0,
                                                               device="cpu"))
    batches = _batches(case.arch)[:3]
    (r,) = TR.run_ranks(1, TR.world1_checks, (case, params, batches), tmp_path)
    d_losses, d_params = r["direct"]
    for k in ("a", "b"):
        hist, got = r[k]
        assert [h[0] for h in hist] == d_losses, k
        assert all(np.array_equal(g, w) for (_, g), (_, w) in
                   zip(PRM.tree_paths(got), PRM.tree_paths(d_params))), k
    w_losses, w_params = r["wire_direct"]
    hist, got = r["c"]
    assert [h[0] for h in hist] == w_losses
    assert all(np.array_equal(g, w) for (_, g), (_, w) in
               zip(PRM.tree_paths(got), PRM.tree_paths(w_params)))
    # under int8_switchback the wire's codes are the ones the forward's
    # tensor quantizer makes of the same weight (the reference's "free"
    # compression): the step is the one without the wire
    assert w_losses == d_losses
    assert r["wire_fault"][0] != w_losses          # the control fault is caught


# ---------------------------------------------------------------------------
# edges: checkpoints, the supervisor
# ---------------------------------------------------------------------------

CKPT_CASE = TR.Case("smollm-360m", (2, 1), FSDP)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt"))
    r0, r1 = TR.run_ranks(2, TR.checkpoint_writer, (CKPT_CASE, root), root)
    return root, r0, r1


def _same_state(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_world2_checkpoint_resume_matches_uninterrupted(written):
    _, r0, r1 = written
    assert r0["full"] == r1["full"] and r0["resumed"] == r1["resumed"]
    assert r0["start"] == 4
    assert r0["resumed"] == r0["full"][4:]
    assert _same_state(r0["resumed_at4"], r0["at4"])
    whole = [tuple(s.shape) for s in PRM.tree_leaves(_specs(CKPT_CASE.arch))]
    assert any(loc != w for loc, w in zip(r0["local_shapes"], whole))   # params split


def test_world2_checkpoint_restores_at_world1_and_back(written, tmp_path):
    root, r0, _ = written
    case1 = CKPT_CASE.at((1, 1))
    (one,) = TR.run_ranks(1, TR.checkpoint_reader, (case1, os.path.join(root, "b"),
                                                    str(tmp_path / "w1")), tmp_path)
    assert one["start"] == 4 and _same_state(one["state"], r0["at4"])
    # a world-1 save of the same state writes the same bytes, and the
    # initial states of both worlds checkpoint alike
    assert one["crcs4"] == r0["crcs4"] and one["crcs0"] == r0["crcs0"]
    assert _same_state(one["init"], r0["init"])
    back = TR.run_ranks(2, TR.checkpoint_reader, (CKPT_CASE, str(tmp_path / "w1"),
                                                  str(tmp_path / "w2")), tmp_path)
    assert back[0]["start"] == 4 and _same_state(back[0]["state"], r0["at4"])
    assert back[0]["crcs4"] == r0["crcs4"]


def test_supervised_nan_recovery_on_sharded_engine(tmp_path):
    """The port of tests/test_engine.py's supervisor test on 2 ranks."""
    r0, r1 = TR.run_ranks(2, TR.supervised_nan, (CKPT_CASE, str(tmp_path)), tmp_path)
    assert r0 == r1
    rep = r0["report"]
    assert rep["rewinds"] >= 1
    assert rep["incident_kinds"].get("nonfinite") == 1
    assert rep["post_recovery_spikes"] == []
    assert len(r0["losses"]) == 16 and all(np.isfinite(r0["losses"]))
    assert r0["split"] and all(r0["split"])


# ---------------------------------------------------------------------------
# the int8 wire's gradient
# ---------------------------------------------------------------------------

def _jax_wire_ctx():
    par = JParallel(mesh_shape=(1, 1), mesh_axes=("data", "model"), fsdp=True,
                    fsdp_gather_weights=True, gather_wire="int8")
    rules = JP.default_rules(par)
    return JP.ShardCtx(jax_mesh((1, 1)), rules, JP.nofsdp_rules(rules, rules["batch"]),
                       gather_fsdp=True, gather_wire="int8")


def test_reference_int8_wire_gradient_is_zero_off_the_absmax():
    """ROADMAP.md Queue 3 #5: ``jax.grad`` through the reference's
    ``use_weight`` under the int8 wire passes through ``astype(int8)`` and
    is zero everywhere but at the absmax element."""
    w = jnp.asarray([[0.1, -0.5], [0.3, 0.2]], jnp.float32)
    with _jax_wire_ctx():
        g = jax.grad(lambda w: JP.use_weight(w, ("embed", "heads"), jnp.float32).sum())(w)
    g = np.asarray(g)
    assert g[0, 1] != 0 and np.count_nonzero(g) == 1
    np.testing.assert_allclose(g[0, 1], -0.19685, atol=1e-5)
    w = jnp.asarray(np.random.default_rng(0).normal(size=(64, 48)), jnp.float32)
    with _jax_wire_ctx():
        g = jax.grad(lambda w: JP.use_weight(w, ("embed", "heads"), jnp.float32).sum())(w)
    assert np.count_nonzero(np.asarray(g)) == 1


def _jax_wire(w):
    """The reference wire's quantize-dequantize (repro/models/params.py)."""
    absmax = jnp.maximum(jnp.max(jnp.abs(w.astype(jnp.float32))), 1e-12)
    q = jnp.round(w.astype(jnp.float32) * (127.0 / absmax)).astype(jnp.int8)
    return (q.astype(jnp.float32) * (absmax / 127.0)).astype(w.dtype)


@pytest.fixture(scope="module")
def wire_inputs():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(64, 48)).astype(np.float32) * 0.05
    w[3, 7] = 0.4                                       # one clear absmax
    return w, rng.normal(size=(64, 48)).astype(np.float32)


def test_int8_wire_is_straight_through(wire_inputs):
    """ROADMAP.md Queue 3 #4: the port's wire gives the reference's
    dequantized weight bit for bit and the gradient of the JAX function
    ``w + stop_gradient(deq(q(w)) - w)``: straight through, the bf16
    wire's."""
    w, c = wire_inputs
    with _jax_wire_ctx():
        ref = JP.use_weight(jnp.asarray(w), ("embed", "heads"), jnp.bfloat16)
    jg = jax.grad(lambda w: jnp.sum((lambda b: b + jax.lax.stop_gradient(_jax_wire(b) - b))(
        w.astype(jnp.bfloat16)).astype(jnp.float32) * c))(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    out = PRM.int8_wire(wt.to(torch.bfloat16))
    (g,) = torch.autograd.grad(torch.sum(out.float() * torch.from_numpy(c)), wt)
    assert np.array_equal(out.detach().float().numpy(), np.asarray(ref, np.float32))
    assert np.array_equal(g.numpy(), np.asarray(jg))
    assert np.count_nonzero(g.numpy()) > 1


def test_sharded_int8_wire_equals_the_whole_weights(wire_inputs, tmp_path):
    """Over 2 ranks the absmax is the whole weight's (reduced before the
    codes are made): each rank's gathered weight is the whole weight's
    wire, and its gradient slice the straight-through gradient summed over
    the ranks (each rank used the whole weight once)."""
    w, c = wire_inputs
    wt = torch.from_numpy(w).requires_grad_(True)
    out = PRM.int8_wire(wt.to(torch.bfloat16))
    (g,) = torch.autograd.grad(torch.sum(out.float() * torch.from_numpy(c)), wt)
    ranks = TR.run_ranks(2, TR.sharded_wire, (w, c), tmp_path)
    whole = out.detach().float().numpy()
    for r, (got, gr) in enumerate(ranks):
        assert np.array_equal(got, whole)
        assert np.array_equal(gr, 2 * g.numpy()[32 * r:32 * (r + 1)])
    # the control fault: an absmax per shard gives other codes
    halves = np.concatenate([PRM.int8_wire(torch.from_numpy(h).to(torch.bfloat16)).float()
                             .numpy() for h in np.split(w, 2)])
    assert not np.array_equal(halves, whole)


# ---------------------------------------------------------------------------
# what the port does not shard, and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,pure_dp", [((2, 2), False), ((1, 4), False), ((2, 2), True)])
def test_model_axis_without_pure_dp_raises_queue_13(shape, pure_dp):
    par = ParallelConfig(mesh_shape=shape, pure_dp=pure_dp)
    if pure_dp:
        require_data_axes(par)
        return
    with pytest.raises(NotImplementedError, match="Queue 1 #13"):
        require_data_axes(par)


def test_cli_mesh_test_without_pure_dp_raises_queue_13():
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match="Queue 1 #13"):
        train.main(["--device", "cpu", "--devices", "4", "--mesh", "test", "--steps", "1"])


@pytest.mark.parametrize("field,value,item", [("sequence_parallel", True, "#13"),
                                              ("moe_grouped", False, "#13")])
def test_parallel_config_refuses_unported_fields(field, value, item):
    """``moe_grouped=False`` is a config the port takes (at world 1 it is
    the grouped computation); the JAX package's global sort it asks for at
    a world above 1 raises where it would run (models/moe.py)."""
    if field == "moe_grouped":
        from repro_torch.models import moe as MOE

        class TwoRanks:
            def size(self, axes):
                return 2

        par = ParallelConfig(**{field: value})
        with PRM.ShardCtx(TwoRanks(), {}, moe_grouped=par.moe_grouped, batch=("data",)):
            with pytest.raises(NotImplementedError, match=item):
                MOE.require_local_groups(64, 8)
    else:
        with pytest.raises(NotImplementedError, match=item):
            ParallelConfig(**{field: value})
    # a library flag no step reads, as in the JAX package
    assert ParallelConfig(grad_compression="int8_rowwise").grad_compression == "int8_rowwise"


def test_train_cli_on_four_ranks_prints_the_mesh_line():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "smollm-360m", "--steps", "3", "--device", "cpu", "--devices", "4",
                          "--pure-dp", "--fsdp", "--batch", "8", "--seq", "16"],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    # the JAX launcher's line (repro/launch/train.py), printed once (rank 0)
    lines = re.findall(r"^\[train\] mesh .*$", out.stdout, re.M)
    assert lines == ["[train] mesh {'data': 4, 'model': 1} fsdp=True pure_dp=True — "
                     "11/11 param tensors partitioned, step donated"]
    assert out.stdout.count("final loss:") == 1
