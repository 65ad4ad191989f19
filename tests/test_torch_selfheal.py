"""The port's fault injection and self-healing supervisor against the JAX
package's, on the CPU.

* Fault plans: the same JSON plan gives the same firing and
  ``fired_counts``; ``poison_batch`` gives the JAX package's bits (the
  labels' permutation from ``RandomState(data_idx)``; float leaves times
  1e4 where there are no labels, as in CLIP's batches); the post-step
  faults multiply the parameters and the reported grad norm as JAX's do;
  the checkpoint faults damage the same file.
* The supervisor: the reduced smollm-360m in ``int8_switchback`` (the JAX
  package's parameters carried across, its step on the ``xla`` backend
  jitted with XLA's excess precision off, the port's flash_scan plain
  versions) under the same fault plans and a config whose detection only
  the faults can trip: equal ``report()``s (the rewind log's detail, which
  prints the step's loss, left out), an escalation to ``TrainingAborted``
  and a retried save among them, and every step's loss within
  ``test_torch_train.py``'s LOSS_TOL (1e-3 relative) of JAX's.
* ``chip_smoke.py`` phase 29's constants: the JAX supervisor and the
  port's, on the reduced CLIP ViT-H/14 (2 + 2 layers, zero-init
  layer-scale, int8_switchback, patch dropout on) under phase 29's plan
  and config with telemetry on, give the pinned report and event sequence.
* The data pipeline: ``DeterministicBatcher`` gives the JAX package's
  batches for a data index, ``PrefetchIterator`` yields the JAX one's
  ``(step, batch)`` pairs, runs ``device_put_fn`` in the consumer (never
  on its worker thread) and raises a worker's error there, and a Trainer
  fed from it takes the steps of a Trainer fed by the function.
* The port against itself at that reduced CLIP: a crash and a resume, and
  a resume past a torn checkpoint, reach the clean run's losses and final
  state bit for bit; a plain Trainer fed the shifted stream that the
  supervised run's rewind log implies reaches the supervised run's final
  state bit for bit, and each control fault (a restore that leaves the
  generator as it was, a skip one index short) breaks that equality.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import warnings
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import SupervisorConfig as JSupCfg
from repro.configs.base import TrainConfig as JTrain
from repro.core.precision import QuantPolicy as JPolicy
from repro.data import SyntheticCLIP as JCLIP
from repro.data.pipeline import DeterministicBatcher as JBatcher
from repro.data.pipeline import PrefetchIterator as JPrefetch
from repro.models import build as jax_build
from repro.models.params import init_params as jax_init_params
from repro.telemetry import Telemetry as JTelemetry
from repro.train import FaultPlan as JPlan
from repro.train import FaultSpec as JSpec
from repro.train import TrainingAborted as JAborted
from repro.train import TrainSupervisor as JSupervisor
from repro.train import init_train_state as jax_init_state
from repro.train import make_train_setup as jax_setup
from repro.train import make_train_step as jax_step
from repro_torch.configs import get_reduced_config
from repro_torch.configs.base import ParallelConfig, SupervisorConfig, TrainConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.data import BigramLM, DeterministicBatcher, PrefetchIterator, SyntheticCLIP
from repro_torch.models import build
from repro_torch.models.params import from_numpy_tree, tree_paths
from repro_torch.telemetry import Telemetry
from repro_torch.telemetry.report import load
from repro_torch.train import (FaultPlan, FaultSpec, SimulatedCrash, Trainer, TrainingAborted,
                               TrainSupervisor, init_train_state, make_train_setup,
                               make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as C  # noqa: E402

torch.set_num_threads(1)

MODE = "int8_switchback"
LOSS_TOL = 1e-3                 # test_torch_train.py's, for every mode
N_STEPS = 15
BATCH, SEQ = 2, 16
# detection only the injected faults can trip (the EMA ratios far past a
# sound step's spread, no spike detector), checkpoints every 3 steps
SUP = dict(checkpoint_every=3, keep_checkpoints=4, log_every=0, detect_warmup=2,
           grad_norm_ratio=1e3, loss_jump_ratio=1e3, spike_min_history=100)


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

PLAN_JSON = ('[{"step": 3, "kind": "nan_grad"}, {"step": 5, "kind": "crash", "key": "step"},'
             ' {"step": 4, "kind": "explode_grad", "key": "step", "once": false, "scale": 2.0},'
             ' {"step": 6, "kind": "fail_save", "key": "step"}]')
MATCHES = [(3, ("nan_grad",), "data"), (3, ("nan_grad",), "data"), (4, ("explode_grad",), "step"),
           (4, ("explode_grad",), "step"), (4, ("explode_grad",), "data"),
           (5, ("crash",), "step"), (6, ("fail_save",), "step"), (6, ("fail_save",), "step")]


def test_fault_plans_fire_as_jax(tmp_path):
    p = tmp_path / "plan.json"
    p.write_text(PLAN_JSON)
    for src in (PLAN_JSON, str(p)):
        jplan, tplan = JPlan.from_json(src), FaultPlan.from_json(src)
        got = [(None if a is None else a.kind, None if b is None else b.kind)
               for a, b in ((jplan._match(*m), tplan._match(*m)) for m in MATCHES)]
        assert all(a == b for a, b in got) and got[0][0] == "nan_grad" and got[1][0] is None
        assert tplan.fired_counts() == jplan.fired_counts() == {
            "nan_grad": 1, "crash": 1, "explode_grad": 2, "fail_save": 1}


@pytest.mark.parametrize("spec", [dict(step=1, kind="gremlin"),
                                  dict(step=1, kind="nan_grad", key="both")])
def test_fault_spec_validation_matches_jax(spec):
    with pytest.raises(ValueError) as je:
        JSpec(**spec)
    with pytest.raises(ValueError) as te:
        FaultSpec(**spec)
    assert str(te.value) == str(je.value)


def test_poison_batch_gives_jax_bits():
    """Labels permuted by RandomState(data_idx); without labels (CLIP) the
    float leaves times 1e4, the integer ones untouched."""
    lm = BigramLM(64, seed=3).batch(4, 16)
    clip = SyntheticCLIP(16, 8, 64, n_classes=4, seed=3).batch(3)
    clip.pop("class_ids")
    for batch in (lm, clip):
        spec = [dict(step=11, kind="poison_batch")]
        jout = JPlan([JSpec(**s) for s in spec]).apply_batch(
            11, {k: jnp.asarray(v) for k, v in batch.items()})
        tout = FaultPlan([FaultSpec(**s) for s in spec]).apply_batch(
            11, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k, v in batch.items():
            want, got = np.asarray(jout[k]), tout[k].numpy()
            assert got.dtype == v.dtype and np.array_equal(got.view(np.uint8),
                                                           want.astype(v.dtype).view(np.uint8)), k
        assert not np.array_equal(np.asarray(jout["labels" if "labels" in batch else "images"]),
                                  batch["labels" if "labels" in batch else "images"])
    # the plan's other indices pass the batch through untouched
    same = FaultPlan([FaultSpec(step=11, kind="poison_batch")]).apply_batch(10, {"x": 1})
    assert same == {"x": 1}


@pytest.mark.parametrize("kind", ["nan_grad", "inf_grad", "explode_grad"])
def test_post_step_faults_match_jax(kind):
    rs = np.random.default_rng(5)
    params = {"w": rs.standard_normal((3, 4)).astype(np.float32),
              "b": {"g": rs.standard_normal(4).astype(np.float32)}}
    St = namedtuple("St", "params step")       # a NamedTuple, as TrainState
    spec = [dict(step=2, kind=kind, scale=3.0)]
    js, jm = JPlan([JSpec(**s) for s in spec]).apply_post_step(
        9, 2, St(jax.tree.map(jnp.asarray, params), 0), {"grad_norm": jnp.float32(2.5)})
    ts, tm = FaultPlan([FaultSpec(**s) for s in spec]).apply_post_step(
        9, 2, St(from_numpy_tree(params, device="cpu"), 0), {"grad_norm": torch.tensor(2.5)})
    for (k, t), (_, j) in zip(tree_paths(ts.params), tree_paths(js.params)):
        assert np.array_equal(t.numpy(), np.asarray(j), equal_nan=True), k
    assert np.array_equal(tm["grad_norm"].numpy(), np.asarray(jm["grad_norm"]), equal_nan=True)


@pytest.mark.parametrize("kind", ["corrupt_ckpt", "truncate_ckpt"])
def test_checkpoint_faults_damage_what_jax_damages(tmp_path, kind):
    from repro.train.faults import FaultyCheckpointManager as JFaulty
    from repro_torch.train.faults import FaultyCheckpointManager
    tree = {f"leaf{i}": np.arange(50 * (i + 1), dtype=np.float32) for i in range(5)}
    out = {}
    for tag, Faulty, Plan, Spec in (("jax", JFaulty, JPlan, JSpec),
                                    ("port", FaultyCheckpointManager, FaultPlan, FaultSpec)):
        m = Faulty(str(tmp_path / tag), plan=Plan([Spec(step=6, kind=kind, key="step")]))
        m.save(6, tree)
        d = tmp_path / tag / "step_00000006"
        out[tag] = (sorted(os.listdir(tmp_path / tag)), m.all_steps(), m.valid_steps(),
                    {f: (d / f).read_bytes() for f in sorted(os.listdir(d))
                     if f.endswith(".npy")})
    assert out["port"] == out["jax"]
    assert out["port"][2] == []


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

def test_deterministic_batcher_matches_jax():
    make = {"jax": lambda s: JCLIP(16, 8, 64, n_classes=4, seed=s),
            "port": lambda s: SyntheticCLIP(16, 8, 64, n_classes=4, seed=s)}
    jb, tb = JBatcher(make["jax"], seed=40), DeterministicBatcher(make["port"], seed=40)
    for j in (3, 0, 3, 17):
        a, b = jb.batch_at(j, batch_size=5), tb.batch_at(j, batch_size=5)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_prefetch_iterator_matches_jax(loops):
    import threading
    fn_batch = lambda s: BigramLM(64, seed=s).batch(2, 8)  # noqa: E731
    threads = []

    def put(b):
        threads.append(threading.current_thread())
        return {k: torch.from_numpy(v).long() for k, v in b.items()}

    jit, tit = JPrefetch(fn_batch, start_step=3), PrefetchIterator(fn_batch, start_step=3,
                                                                    device_put_fn=put)
    for _ in range(4):
        (js, jb), (ts, tb) = next(jit), next(tit)
        assert js == ts and all(np.array_equal(np.asarray(jb[k]), tb[k].numpy()) for k in jb)
    jit.close()
    tit.close()
    assert threads and all(t is threading.main_thread() for t in threads)

    def broken(s):
        if s == 2:
            raise KeyError("no batch 2")
        return fn_batch(s)
    it = PrefetchIterator(broken)
    assert next(it)[0] == 0 and next(it)[0] == 1
    with pytest.raises(KeyError):
        next(it)
    # a Trainer fed from the iterator takes the function's steps
    fn, fresh, data_fn = loops["port"]
    runs = []
    for source in (data_fn, PrefetchIterator(lambda j: {k: v.numpy() for k, v in
                                                        data_fn(j).items()},
                                             device_put_fn=lambda b: {
                                                 k: torch.from_numpy(v) for k, v in b.items()})):
        t = Trainer(fn, fresh(), log_every=0)
        t.run(source, 4)
        runs.append([h["loss"] for h in t.history])
    source.close()
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# the supervisor against the JAX package's (reduced smollm-360m)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loops():
    jcfg, tcfg = jax_reduced("smollm-360m"), get_reduced_config("smollm-360m")
    jp = jax_init_params(jax_build(jcfg).param_specs, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=100, beta2=0.95,
              loss_scaler="none", quant_mode=MODE)
    jtc, ttc = JTrain(**kw), TrainConfig(**kw)
    jopt, jscaler = jax_setup(jtc)
    opt, scaler = make_train_setup(ttc)
    cache = {}

    def batch(j):
        """Data index j's batch (BigramLM seeded by j), numpy, cached."""
        if j not in cache:
            cache[j] = BigramLM(tcfg.vocab_size, seed=1000 + j, temperature=0.3).batch(BATCH, SEQ)
        return cache[j]

    jb = lambda j: {k: jnp.asarray(v) for k, v in batch(j).items()}  # noqa: E731
    tb = lambda j: {k: torch.from_numpy(v).long() for k, v in batch(j).items()}  # noqa: E731
    jstep = jax_step(jax_build(jcfg), JPolicy(MODE, backend="xla"),
                     JParallel(mesh_shape=(1, 1), remat="none", attn_impl="flash_scan"),
                     jtc, jopt, jscaler)
    jstate0 = jax_init_state(jp, jopt, jscaler)
    jfn = jax.jit(jstep).lower(jstate0, jb(0)).compile(
        compiler_options={"xla_allow_excess_precision": False})
    tfn = make_train_step(build(tcfg), QuantPolicy(MODE),
                          ParallelConfig(remat="none", attn_impl="flash_scan"), ttc, opt, scaler)
    return dict(
        jax=(jfn, lambda: jax_init_state(jp, jopt, jscaler), jb),
        port=(tfn, lambda: init_train_state(from_numpy_tree(np_params, device="cpu"),
                                            opt, scaler), tb))


def _without_detail(rep):
    return {**rep, "rewind_log": [{k: v for k, v in e.items() if k != "detail"}
                                  for e in rep["rewind_log"]]}


def _supervise(loops, which, plan, directory):
    fn, fresh, data_fn = loops[which]
    Sup, Cfg, Aborted = ((JSupervisor, JSupCfg, JAborted) if which == "jax"
                         else (TrainSupervisor, SupervisorConfig, TrainingAborted))
    sup = Sup(fn, fresh(), data_fn, checkpoint_dir=str(directory), config=Cfg(**SUP),
              fault_plan=plan)
    sup.trainer.early_checkpoint_on_slow = False
    try:
        sup.run(N_STEPS)
        aborted = None
    except Aborted as e:
        aborted = (e.reason, _without_detail(e.report))
    return _without_detail(sup.report()), aborted, [h["loss"] for h in sup.trainer.history]


PLANS = {
    "nan": [dict(step=7, kind="nan_grad")],
    "poison+nan": [dict(step=8, kind="poison_batch"), dict(step=8, kind="nan_grad")],
    "sticky_abort": [dict(step=7, kind="nan_grad", key="step", once=False)],
    "fail_save+explode": [dict(step=9, kind="fail_save", key="step"),
                          dict(step=10, kind="explode_grad")],
    "corrupt+inf": [dict(step=6, kind="corrupt_ckpt", key="step"), dict(step=7, kind="inf_grad")],
    "torn+nan": [dict(step=9, kind="truncate_ckpt", key="step"), dict(step=10, kind="nan_grad")],
}


@pytest.mark.parametrize("name", list(PLANS))
def test_supervisor_matches_jax(loops, tmp_path, name):
    out = {w: _supervise(loops, w, (JPlan if w == "jax" else FaultPlan)(
        [(JSpec if w == "jax" else FaultSpec)(**s) for s in PLANS[name]]), tmp_path / w)
        for w in ("jax", "port")}
    (jrep, jab, jloss), (trep, tab, tloss) = out["jax"], out["port"]
    assert trep == jrep and tab == jab
    assert trep["rewinds"] >= 1
    if name == "sticky_abort":
        assert tab is not None and trep["escalations"] == SupervisorConfig().max_retries
    else:
        assert tab is None and len(tloss) == N_STEPS and all(np.isfinite(tloss))
    if name == "fail_save+explode":
        assert trep["save_failures"] == trep["save_retries"] == 1
    assert len(tloss) == len(jloss)
    rel = [abs(a - b) / abs(b) for a, b in zip(tloss, jloss)]
    assert max(rel) <= LOSS_TOL, (tloss, jloss)


def test_supervisor_requires_checkpointing(loops):
    fn, fresh, data_fn = loops["port"]
    with pytest.raises(ValueError, match="checkpoint"):
        TrainSupervisor(fn, fresh(), data_fn, checkpoint_dir="", config=SupervisorConfig(**SUP))
    with pytest.raises(ValueError, match="checkpoint"):
        TrainSupervisor(fn, fresh(), data_fn, checkpoint_dir="ck",
                        config=SupervisorConfig(checkpoint_every=0))


# ---------------------------------------------------------------------------
# chip_smoke.py phase 29 at the reduced CLIP
# ---------------------------------------------------------------------------

CLIP_BATCH = 4


def _jax_clip_supervised(directory, telemetry):
    cfg = dataclasses.replace(jax_reduced("clip-vit-huge"), vision_layers=2, text_layers=2,
                              layer_scale_init=0.0)
    tc = JTrain(learning_rate=C.CLIP_OPT["lr"], warmup_steps=C.CLIP_OPT["warmup"],
                total_steps=100, quant_mode=MODE)
    opt, scaler = jax_setup(tc)
    bundle = jax_build(cfg)
    fn = jax.jit(jax_step(bundle, JPolicy(MODE), JParallel(remat="none"), tc, opt, scaler))
    batcher = JBatcher(lambda s: JCLIP(cfg.image_size, cfg.text_ctx, cfg.text_vocab,
                                       n_classes=32, seed=s), seed=C.SELFHEAL_DATA_SEED)
    cache = {}

    def data_fn(j):
        if j not in cache:
            cache[j] = {k: jnp.asarray(v) for k, v in batcher.batch_at(
                j, batch_size=CLIP_BATCH).items() if k != "class_ids"}
        return cache[j]

    state = jax_init_state(jax_init_params(bundle.param_specs, jax.random.PRNGKey(0)), opt,
                           scaler)
    sup = JSupervisor(fn, state, data_fn, checkpoint_dir=str(directory),
                      config=JSupCfg(**C.SELFHEAL_SUP),
                      fault_plan=JPlan([JSpec(**f) for f in C.SELFHEAL_PLAN]),
                      telemetry=telemetry)
    sup.trainer.early_checkpoint_on_slow = False
    sup.run(C.SELFHEAL_STEPS)
    return sup


@pytest.fixture(scope="module")
def clip_path():
    return C.selfheal_parts(torch, get_reduced_config("clip-vit-huge"), torch.device("cpu"), 0,
                            batch=CLIP_BATCH)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_phase29_report_and_events_are_the_pinned_ones(clip_path, tmp_path, which):
    """Phase 29's SELFHEAL_REPORT and SELFHEAL_EVENTS, from the JAX
    package's supervisor and the port's under phase 29's plan, config and
    profile window: detection depends only on the faults, so the reduced
    width gives what the card must."""
    path = str(tmp_path / "run.jsonl")
    Tele = JTelemetry if which == "jax" else Telemetry
    tele = Tele(path, profile_steps=C.SELFHEAL_PROFILE, profile_dir=str(tmp_path / "prof"),
                program="train")
    try:
        sup = (_jax_clip_supervised(tmp_path / "ck", tele) if which == "jax"
               else C.selfheal_supervised(clip_path, str(tmp_path / "ck"), telemetry=tele))
    finally:
        tele.close()
    assert C.report_key(sup.report()) == C.SELFHEAL_REPORT
    assert C.event_sequence(load(path)) == C.SELFHEAL_EVENTS
    assert all(np.isfinite(h["loss"]) for h in sup.trainer.history)


def _trainer_run(P, directory=None, plan=None, n=C.SELFHEAL_STEPS, state=None):
    t = C.selfheal_trainer(P, state or P.fresh_state(), directory, plan=plan)
    t.run(P.data_fn, n)
    return t


@pytest.fixture(scope="module")
def clean_run(clip_path, tmp_path_factory):
    t = _trainer_run(clip_path, str(tmp_path_factory.mktemp("clean")))
    return [h["loss"] for h in t.history], C.state_digest(torch, t.state)


def test_crash_and_resume_is_bit_identical(clip_path, clean_run, tmp_path):
    losses, digest = clean_run
    P = clip_path
    with pytest.raises(SimulatedCrash):
        _trainer_run(P, str(tmp_path), plan=FaultPlan([FaultSpec(step=7, kind="crash",
                                                                 key="step")]))
    t = C.selfheal_trainer(P, P.fresh_state(), str(tmp_path))
    t.ckpt.wait()
    assert t.maybe_resume() == 6
    t.run(P.data_fn, C.SELFHEAL_STEPS - 6)
    assert [h["loss"] for h in t.history] == losses[6:]
    assert C.state_digest(torch, t.state) == digest
    # a torn newest checkpoint and a stray .tmp: fall back one, same end
    newest = tmp_path / "step_00000012"
    leaf = sorted(f for f in os.listdir(newest) if f.endswith(".npy"))[0]
    with open(newest / leaf, "r+b") as f:
        f.truncate(16)
    os.makedirs(tmp_path / "step_00000015.tmp")
    t = C.selfheal_trainer(P, P.fresh_state(), str(tmp_path))
    with pytest.warns(UserWarning, match="skipping corrupt"):
        assert t.maybe_resume() == 9
    t.run(P.data_fn, C.SELFHEAL_STEPS - 9)
    assert C.state_digest(torch, t.state) == digest


def test_shifted_stream_reaches_the_supervised_state(clip_path, tmp_path):
    P = clip_path
    sup = C.selfheal_supervised(P, str(tmp_path / "c"))
    digest = C.state_digest(torch, sup.trainer.state)
    idx = C.shifted_indices(sup.report()["rewind_log"], C.SELFHEAL_STEPS)
    assert idx == [0, 1, 2, 8, 9, 10, 14, 15, 16, 17, 18, 19]

    def shifted(indices):
        t = C.selfheal_trainer(P, P.fresh_state())
        t.run(lambda i: (indices[i], P.data_fn(indices[i])), C.SELFHEAL_STEPS)
        return C.state_digest(torch, t.state), [h["loss"] for h in t.history]

    got, losses = shifted(idx)
    assert got == digest and losses == [h["loss"] for h in sup.trainer.history]
    # the control faults break the equality
    assert shifted([j - 1 if j != i else j for i, j in enumerate(idx)])[0] != digest
    with C.generator_kept(), warnings.catch_warnings():
        g = C.selfheal_supervised(P, str(tmp_path / "e"))
    assert C.state_digest(torch, g.trainer.state) != got
