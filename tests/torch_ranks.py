"""Spawned gloo ranks for the port's multi-process tests.

``run_ranks(world, fn, args, tmp_path)`` starts ``world`` processes that
join one gloo group through a file store under ``tmp_path`` (never a fixed
TCP port: several test workers run at once), each runs ``fn(*args)`` (a
function of this module, looked up by name) and saves its result; the
caller gets the results in rank order. The group joins under its own
timeout and every collective times out, so a hung rank fails the test
that spawned it. The ranks import the port only, never JAX.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import traceback
import uuid

import numpy as np
import torch

#: seconds a spawned group may take, and a collective may wait
JOIN_TIMEOUT = 300
COLLECTIVE_TIMEOUT = 120


def _main(rank, world, store, name, args, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    try:
        res = globals()[name](*args)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, fn, args, tmp_path, timeout: float = JOIN_TIMEOUT) -> list:
    """``fn(*args)`` on ``world`` gloo ranks; their results in rank order."""
    out = os.path.join(str(tmp_path), f"{fn.__name__}-{world}-{uuid.uuid4().hex[:8]}")
    os.makedirs(out)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_main, args=(r, world, os.path.join(out, "store"), fn.__name__,
                                             args, out)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    for p in procs:
        p.join(max(0.0, (deadline - datetime.datetime.now()).total_seconds()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = [open(os.path.join(out, f)).read() for f in sorted(os.listdir(out))
            if f.endswith(".err")]
    assert not hung, f"ranks {hung} of {world} still running after {timeout} s: {errs}"
    assert all(p.exitcode == 0 for p in procs), (
        f"exit codes {[p.exitcode for p in procs]}: " + "\n".join(errs))
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Case:
    """One engine run: ``arch``'s reduced config on a mesh of ``shape``
    with the ParallelConfig fields ``par``, ``mode`` (bf16 under the JAX
    engine tests' policy, f32 compute), ``optimizer``, ``micro``
    microbatches, and for a mixture of experts ``moe_cf`` its capacity
    factor."""
    arch: str
    shape: tuple
    par: tuple = ()
    optimizer: str = "stable_adamw"
    micro: int = 1
    mode: str = "bf16"
    moe_cf: float = 0.0              # the MoE capacity factor, when set (0: the config's)

    def at(self, shape) -> "Case":
        return dataclasses.replace(self, shape=shape)


def _parts(case: Case, keeps=None):
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.precision import QuantPolicy
    from repro_torch.models import build
    cfg = get_reduced_config(case.arch)
    if case.moe_cf:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               capacity_factor=case.moe_cf))
    bundle = build(cfg)
    if keeps is not None:
        it = iter(keeps)
        bundle = dataclasses.replace(bundle, patch_keep=lambda gen: torch.as_tensor(next(it)))
    par = ParallelConfig(mesh_shape=case.shape, mesh_axes=("data", "model"), remat="block",
                         **dict(case.par))
    tc = TrainConfig(optimizer=case.optimizer, learning_rate=1e-3, warmup_steps=2,
                     total_steps=100, loss_scaler="none", quant_mode=case.mode,
                     microbatch_steps=case.micro)
    policy = (QuantPolicy("bf16", compute_dtype=torch.float32) if case.mode == "bf16"
              else QuantPolicy(case.mode))
    return bundle, par, tc, policy


def _tensors(batch):
    return {k: torch.as_tensor(np.asarray(v)).long() if np.asarray(v).dtype.kind in "iu"
            else torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def engine_run(case: Case, params, batches, keeps=None):
    """The engine's trajectory: per step (loss, grad norm), and the final
    parameters gathered whole (numpy)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.params import tree_map
    from repro_torch.train import make_engine
    bundle, par, tc, policy = _parts(case, keeps)
    eng = make_engine(bundle, tc, par, make_test_mesh(case.shape), _tensors(batches[0]),
                      policy=policy)
    state = eng.init_state(0, params=params)
    hist = []
    for b in batches:
        state, m = eng.step(state, eng.shard_batch(_tensors(b)))
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    whole = eng.state_shardings.gather(state)
    return hist, tree_map(lambda t: t.numpy(), whole.params)


def engine_runs(jobs):
    """``engine_run`` of each (case, params, batches, keeps) in turn."""
    return [engine_run(*job) for job in jobs]


def _direct(case: Case, params, batches, patch=None):
    """The one-device step (no engine) on the same inputs; ``patch``
    replaces ``use_weight`` for the run."""
    from repro_torch.models import params as PRM
    from repro_torch.train import init_train_state, make_train_setup, make_train_step
    bundle, par, tc, policy = _parts(case)
    opt, scaler = make_train_setup(tc)
    step = make_train_step(bundle, policy, par, tc, opt, scaler)
    state = init_train_state(PRM.tree_map(lambda a: torch.as_tensor(a).clone(), params),
                             opt, scaler, seed=0)
    real = PRM.use_weight
    if patch is not None:
        PRM.use_weight = lambda w, logical=(), dtype=None: patch(real(w, logical, dtype))
    try:
        losses = []
        for b in batches:
            state, m = step(state, _tensors(b))
            losses.append(float(m["loss"]))
    finally:
        PRM.use_weight = real
    return losses, PRM.tree_map(lambda t: t.numpy(), state.params)


def _halves_int8_wire(w):
    """The control fault: the int8 wire with an absmax per half of the
    first dim (a per-shard absmax over two shards), not the whole
    weight's."""
    from repro_torch.models import params as PRM
    return torch.cat([PRM.int8_wire(h) for h in w.chunk(2, dim=0)], dim=0)


def world1_checks(case: Case, params, batches):
    """At world 1 the engine adds no arithmetic: (a) without fsdp and (b)
    with fsdp, the explicit gather and pure_dp, the losses and final
    parameters of the direct step bit for bit; (c) with the int8 wire, the
    direct step whose weights pass through ``int8_wire``, bit for bit, and
    not the one with an absmax per half (the control fault)."""
    out = {"direct": _direct(case, params, batches)}
    gather = (("fsdp", True), ("fsdp_gather_weights", True), ("pure_dp", True))
    out["a"] = engine_run(case, params, batches)
    out["b"] = engine_run(dataclasses.replace(case, par=gather), params, batches)
    from repro_torch.models import params as PRM
    out["wire_direct"] = _direct(case, params, batches, patch=PRM.int8_wire)
    out["wire_fault"] = _direct(case, params, batches, patch=_halves_int8_wire)
    out["c"] = engine_run(dataclasses.replace(case, par=gather + (("gather_wire", "int8"),)),
                          params, batches)
    return out


def sharded_wire(w, c):
    """``use_weight`` under the int8 wire with the weight's first dim split
    over the group: the forward (whole) and this rank's gradient slice of
    sum(out * c)."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import params as PRM
    n, r = dist.get_world_size(), dist.get_rank()
    mesh = make_test_mesh((n, 1))
    w = torch.as_tensor(w)
    sh = S.LeafShard(tuple(w.shape), ("data", None), 0, ("data",), n, r, mesh.group("data"))
    local = sh.take(w).requires_grad_(True)
    ctx = PRM.ShardCtx(mesh, {}, gather_fsdp=True, gather_wire="int8")
    with ctx:
        ctx.register_weights([("['w']", local, sh)])
        out = PRM.use_weight(local, ("embed", "heads"), torch.bfloat16)
    (g,) = torch.autograd.grad(torch.sum(out.float() * torch.as_tensor(c)), local)
    return out.detach().float().numpy(), g.numpy()


def bigram(j: int, vocab: int = 512, batch: int = 8, seq: int = 16):
    """Data index j's batch, a pure function of j (the JAX engine tests'
    ``_batch``)."""
    from repro_torch.data import BigramLM
    return _tensors(BigramLM(vocab, seed=1000 + j, temperature=0.3).batch(batch, seq))


def _trainer(case: Case, ckpt_dir, every=2, params=None):
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import Trainer, make_engine
    bundle, par, tc, policy = _parts(case)
    eng = make_engine(bundle, tc, par, make_test_mesh(case.shape), bigram(0), policy=policy)
    tr = Trainer(eng.step, eng.init_state(0, params=params), checkpoint_dir=ckpt_dir,
                 checkpoint_every=every, log_every=0, state_shardings=eng.state_shardings)
    return tr, eng


def _whole(eng, state):
    from repro_torch.checkpoint.manager import _flatten_with_paths
    whole = eng.state_shardings.gather(state)
    return {p: (v.get_state() if isinstance(v, torch.Generator) else v).numpy()
            for p, v in _flatten_with_paths(whole)}


def _crcs(directory, step):
    import json
    with open(os.path.join(directory, f"step_{step:08d}", "META.json")) as f:
        return {p: (i["shape"], i["dtype"], i["crc32"]) for p, i in json.load(f)["leaves"].items()}


def checkpoint_writer(case: Case, root):
    """Train 6 steps checkpointing every 2 (``a``); train 4 (``b``), drop
    the trainer (the crash), resume in a new engine and train 2 more. Also
    a checkpoint of the initial state (``init``). Returns the two runs'
    losses, the resumed start step, the state at step 4 gathered whole and
    the checkpoints' leaf records."""
    from repro_torch.models.params import tree_leaves
    full, eng = _trainer(case, os.path.join(root, "a"))
    full.run(bigram, 6)
    t1, e1 = _trainer(case, os.path.join(root, "b"))
    init = _whole(e1, t1.state)
    t1.ckpt.save(0, t1.state)
    crcs0 = _crcs(os.path.join(root, "b"), 0)
    t1.run(bigram, 4)
    at4 = _whole(e1, t1.state)
    crcs4 = _crcs(os.path.join(root, "b"), 4)
    del t1
    t2, e2 = _trainer(case, os.path.join(root, "b"))
    start = t2.maybe_resume()
    resumed_at4 = _whole(e2, t2.state)
    local_shapes = [tuple(t.shape) for t in tree_leaves(t2.state.params)]
    t2.run(bigram, 2)
    return dict(full=[h["loss"] for h in full.history], resumed=[h["loss"] for h in t2.history],
                start=start, init=init, at4=at4, resumed_at4=resumed_at4,
                local_shapes=local_shapes, crcs4=crcs4, crcs0=crcs0)


def checkpoint_reader(case: Case, src, dst):
    """Restore ``src``'s step 4 (written at another world size), return
    the state gathered whole, write it again under ``dst`` (step 4) and
    return that checkpoint's leaf records, and a checkpoint of this
    world's initial state (step 0)."""
    tr, eng = _trainer(case, src)
    init = _whole(eng, tr.state)
    start = tr.restore_checkpoint(4)
    got = _whole(eng, tr.state)
    os.makedirs(dst, exist_ok=True)
    tr.ckpt.directory = dst
    tr.ckpt.save(4, tr.state)
    t0, _ = _trainer(case, os.path.join(dst, "init"))
    t0.ckpt.save(0, t0.state)
    return dict(start=start, state=got, init=init, crcs4=_crcs(dst, 4),
                crcs0=_crcs(os.path.join(dst, "init"), 0),
                losses=[h["loss"] for h in tr.run(bigram, 2)])


def supervised_nan(case: Case, root):
    """The supervisor over the sharded engine with a NaN injected at step
    9 (the JAX engine test's plan): its report, history and whether the
    parameters stayed split."""
    from repro_torch.configs.base import SupervisorConfig
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import FaultPlan, FaultSpec, make_engine
    bundle, par, tc, policy = _parts(case)
    eng = make_engine(bundle, tc, par, make_test_mesh(case.shape), bigram(0), policy=policy)
    sup = eng.make_supervisor(
        eng.init_state(), bigram, checkpoint_dir=root,
        config=SupervisorConfig(checkpoint_every=4, log_every=0, detect_warmup=4,
                                spike_min_history=100),
        fault_plan=FaultPlan([FaultSpec(step=9, kind="nan_grad")]))
    hist = sup.run(16)
    rep = sup.report()
    split = [tuple(t.shape) != tuple(sh.shape) for t, sh in zip(
        tree_leaves(sup.trainer.state.params), tree_leaves(eng.param_shardings)) if sh is not None]
    return dict(report={k: rep[k] for k in ("rewinds", "incident_kinds", "post_recovery_spikes",
                                            "rewind_log", "data_offset")},
                losses=[h["loss"] for h in hist], split=split)


def mesh_facts():
    """What one rank of 4 sees of the port's meshes: sizes, its indices,
    the group ranks in index order, the CLI meshes, a split leaf's round
    trip over ("pod", "data")."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_cli_mesh, make_test_mesh
    rank = torch.tensor([dist.get_rank()])
    out = {}
    m = make_test_mesh((2, 2))
    for axes in (("data",), ("model",), ("data", "model")):
        got = S.gather_dim(rank, 0, m.group(axes), m.size(axes))
        out[axes] = (m.size(axes), m.index(axes), got.tolist())
    out["cli"] = {k: make_cli_mesh(k).shape for k in ("auto", "test", "single")}
    try:
        make_cli_mesh("multi")
    except ValueError as e:
        out["cli"]["multi"] = str(e)
    p = make_test_mesh((2, 2, 1), ("pod", "data", "model"))
    axes = ("pod", "data")
    whole = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    sh = S.leaf_shard(p, (8, 3), (axes, None))
    local = sh.take(whole)
    out["pod"] = (p.index(axes), local.tolist(), bool(torch.equal(sh.gather(local), whole)),
                  S.gather_dim(rank, 0, p.group(axes), 4).tolist())
    return out


def compression(gs, efs):
    """The port's compressed means of this rank's gradients ``gs[rank]``
    (a dict of arrays): each leaf alone, and the tree with error feedback
    over two rounds (the second fed the first's residuals plus ``efs``)."""
    import torch.distributed as dist
    from repro_torch.distributed import compression as C
    g = {k: torch.as_tensor(v) for k, v in gs[dist.get_rank()].items()}
    single = {k: C.compressed_allreduce_mean(v).numpy() for k, v in sorted(g.items())}
    s1, ef1 = C.compressed_tree_allreduce_mean(g)
    ef = {k: ef1[k] + torch.as_tensor(efs[dist.get_rank()][k]) for k in ef1}
    s2, ef2 = C.compressed_tree_allreduce_mean(g, error_feedback=ef)
    to_np = lambda t: {k: v.numpy() for k, v in t.items()}
    return single, to_np(s1), to_np(ef1), to_np(s2), to_np(ef2)
