"""The reduced qwen3-moe-30b-a3b through the port's sharded TrainEngine on
gloo ranks (``torch_ranks.py``), held to the JAX engine with one dispatch
group per data shard and to the port's own world 1, on the CPU.

The JAX engine dispatches tokens in G groups aligned to its data shards (G
= the data ranks). The tests' JAX process sees one device, so its engine
runs on a (1, 1) mesh with ``repro.models.moe._data_group_count`` set to
return the world's G for the run: the same groups over the same token
rows (rank r's rows are group r in both packages), computed on one device.
In the port each rank's tokens are its group, and the aux loss's two
means are all-reduced over the ranks before their product.

* ``fsdp`` on (2, 1) and ``pure_dp`` + ``fsdp`` on (2, 2) (four ranks,
  four groups) under the engine tests' f32-compute policy, at the config's
  capacity factor (tokens drop): every step's loss and grad norm within
  TOL of the JAX engine at G = world (measured 1.4e-7 and 4.8e-7), and not
  within it of the wrong grouping, G = 1 (the control: 3.5e-3 and 5.0e-3
  in the loss).
* At a capacity factor where nothing drops, groups change nothing but the
  aux loss's means, global in both packages: world 2 equals world 1 within
  the engine tests' SELF_TOL and PARAM_TOL (measured 9.5e-8 and 1.2e-9),
  and the JAX engine within TOL.
* ``moe_grouped=False`` at a world above 1 (the JAX package's one global
  sort), or fewer than 2E tokens a rank (its fall-back to one group),
  raises, citing ROADMAP.md Queue 1 #13.

``int8_switchback`` is held to the JAX package model by model
(``tests/test_torch_moe_model.py``); through the engine its quantizers
turn last-bit differences into drops and steps (2e-3 in the loss against
the JAX engine at G = 2, 6.6e-3 at G = 1), too close to tell the groupings
apart.
* ``moe_grouped=False`` at a world above 1 (the JAX package's one global
  sort) raises, citing ROADMAP.md Queue 1 #13.
"""
from __future__ import annotations

import dataclasses

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
from repro.models import moe as JMOE
from repro.train import make_engine as jax_engine
from repro_torch.data import BigramLM
from repro_torch.models import params as PRM

torch.set_num_threads(1)

ARCH = "qwen3-moe-30b-a3b"
STEPS = 3
BATCH, SEQ = 8, 16             # 32 tokens a rank at world 4: >= 2 E (E = 8)
TOL = 1e-5                     # loss and grad norm, relative (f32 compute)
SELF_TOL = 1e-5
PARAM_TOL = 1e-5
NO_DROP_CF = 8.0               # capacity >= every token's k assignments

FSDP = (("fsdp", True),)
PURE = FSDP + (("pure_dp", True),)
CASES = {
    "fsdp-2x1": TR.Case(ARCH, (2, 1), FSDP),
    "pure_dp-fsdp-2x2": TR.Case(ARCH, (2, 2), PURE),
}
NO_DROP = TR.Case(ARCH, (2, 1), FSDP, moe_cf=NO_DROP_CF)


def _batches():
    vocab = jax_reduced(ARCH).vocab_size
    return [BigramLM(vocab, seed=2000 + i, temperature=0.3).batch(BATCH, SEQ)
            for i in range(STEPS)]


def _jax_run(case: TR.Case, batches, groups: int):
    """The JAX engine on a (1, 1) mesh with ``groups`` dispatch groups:
    its initial parameters (numpy) and (loss, grad norm) a step."""
    cfg = jax_reduced(ARCH)
    if case.moe_cf:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               capacity_factor=case.moe_cf))
    tc = JTrain(learning_rate=1e-3, warmup_steps=2, total_steps=100, loss_scaler="none")
    pol = JPolicy("bf16", compute_dtype=jnp.float32)
    par = JParallel(mesh_shape=(1, 1), mesh_axes=("data", "model"), remat="block")
    real = JMOE._data_group_count
    JMOE._data_group_count = lambda T: groups if T % groups == 0 else 1
    try:
        jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        eng = jax_engine(jax_build(cfg), tc, par, jax_mesh((1, 1)), jb[0], policy=pol)
        state = eng.init_state(0)
        params = jax.tree.map(np.asarray, state.params)
        hist = []
        for b in jb:
            state, m = eng.step(state, eng.shard_batch(b))
            hist.append((float(m["loss"]), float(m["grad_norm"])))
    finally:
        JMOE._data_group_count = real
    return params, hist


def _world(shape) -> int:
    return shape[0] * shape[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    batches = _batches()
    jax_runs, jobs = {}, {}
    for name, case in {**CASES, "no-drop": NO_DROP}.items():
        W = _world(case.shape)
        params, hist = _jax_run(case, batches, W)
        jax_runs[name] = dict(hist=hist, one=_jax_run(case, batches, 1)[1])
        cases = [case] + ([case.at((1, 1))] if name == "no-drop" else [])
        for c in cases:
            jobs.setdefault(_world(c.shape), []).append((name, c, params))
    got = {}
    for world, items in sorted(jobs.items()):
        ranks = TR.run_ranks(world, TR.engine_runs,
                             ([(c, p, batches) for _, c, p in items],), tmp)
        for r in ranks[1:]:
            for (h0, _), (h, _) in zip(ranks[0], r):
                assert h == h0                     # every rank reports the same
        for (name, c, _), res in zip(items, ranks[0]):
            got[(name, _world(c.shape))] = res
    return jax_runs, got


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)) / np.abs(np.asarray(want))


@pytest.mark.parametrize("name", list(CASES) + ["no-drop"])
def test_moe_engine_matches_jax_groups_per_shard(name, runs):
    jax_runs, got = runs
    case = {**CASES, "no-drop": NO_DROP}[name]
    hist, _ = got[(name, _world(case.shape))]
    rel = _rel(hist, jax_runs[name]["hist"])
    assert rel.max() <= TOL, (hist, jax_runs[name])
    if name != "no-drop":
        # the control: one global group (JAX's G = 1) is another computation
        wrong = _rel(hist, jax_runs[name]["one"])
        assert wrong[:, 0].max() > TOL, (hist, jax_runs[name]["one"])


def test_moe_engine_world_two_equals_world_one_without_drops(runs):
    """Nothing drops, so the groups differ only in the aux loss's means,
    global in both: world 2 equals world 1."""
    _, got = runs
    (h2, p2), (h1, p1) = got[("no-drop", 2)], got[("no-drop", 1)]
    rel = _rel(h2, h1)
    assert rel[:, 0].max() <= SELF_TOL and rel[:, 1].max() <= SELF_TOL, (h2, h1)
    for (path, a), (_, b) in zip(PRM.tree_paths(p2), PRM.tree_paths(p1)):
        top = float(np.abs(b).max()) or 1.0
        assert float(np.abs(a.astype(np.float64) - b).mean()) / top <= PARAM_TOL, path


def test_moe_grouped_false_at_world_two_raises_queue_13():
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import moe as MOE

    class TwoRanks:
        def size(self, axes):
            return 2

    cfg = get_reduced_config(ARCH)
    for grouped, tokens in ((False, 64), (True, 8)):
        with PRM.ShardCtx(TwoRanks(), {}, moe_grouped=grouped, batch=("data",)):
            with pytest.raises(NotImplementedError, match="Queue 1 #13"):
                MOE.require_local_groups(tokens, cfg.moe.n_experts)
    with PRM.ShardCtx(TwoRanks(), {}, moe_grouped=True, batch=("data",)):
        MOE.require_local_groups(64, cfg.moe.n_experts)
