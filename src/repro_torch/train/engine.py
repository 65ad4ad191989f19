"""TrainEngine: the one train step every consumer runs, on a mesh of
processes. The port of ``repro/train/engine.py`` on the data axes.

Given ``(model, TrainConfig, ParallelConfig, mesh)`` the engine assembles
the sharded TrainState once:

  * each leaf's layout (``state_shardings``): parameters by the
    ``models/params.py`` logical-axis rules, optimizer state by the
    Optimizer protocol's ``state_logical_axes`` (AdamW moments like their
    params, AdaFactor's factored moments by the surviving axes), the
    scaler state, step and generator replicated;
  * a state born sharded and independent of the sharding: ``init_state``
    draws each whole leaf from the ``torch.Generator`` in world 1's order
    and keeps this rank's slice, so every world starts from world 1's
    parameters (the counterpart of the JAX engine's sharding-invariant
    RNG);
  * the batch's layout: every rank builds the global batch from the same
    stream and keeps its rows (``shard_batch``);
  * the train step of ``train_step.make_train_step`` with the collectives
    GSPMD inserts silently made explicit (``_DataParallel``), run inside
    the step's ``ShardCtx`` (the ZeRO-3 weight gathers of ``use_weight``,
    CLIP's global batch in ``gather_rows``).

A sharded leaf is a plain local tensor, this rank's slice, with its
``LeafShard`` in ``state_shardings``; not a ``DTensor``, whose storage the
kernels' ctypes entry points cannot take. The data axes only: a ``model``
axis above 1 without ``pure_dp`` (tensor and sequence parallelism) is
ROADMAP.md Queue 1 #13.

Consumers: ``launch/train.py`` trains every run through it (one process
is a world of one: the sharded step is still the step), the tests hold
its worlds to each other and to the JAX engine, and the Trainer and the
supervisor save and restore whole leaves through ``state_shardings``.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.core.quantization import div
from repro_torch.distributed import sharding as S
from repro_torch.models import params as PRM
from repro_torch.models.params import (_divisible, default_rules, logical_to_pspec,
                                       specs_to_pspecs, tree_leaves, tree_map, tree_paths,
                                       tree_unflatten)
from repro_torch.train.train_step import (TrainState, init_train_state, make_train_setup,
                                          make_train_step)


def require_data_axes(parallel: ParallelConfig, mesh_shape=None) -> None:
    """Raise on a layout the port does not shard: a ``model`` axis above 1
    without ``pure_dp`` (heads, MLP, experts and vocab over ``model`` need
    the quantizers' absmax reduced across shards inside the linears)."""
    shape = dict(zip(parallel.mesh_axes, mesh_shape or parallel.mesh_shape))
    if shape.get("model", 1) > 1 and not parallel.pure_dp:
        raise NotImplementedError(
            f"a 'model' axis of {shape['model']} without pure_dp is tensor parallelism, "
            "not ported yet (ROADMAP.md Queue 1 #13); use pure_dp=True (--pure-dp) or a "
            "model axis of 1")


def make_shard_ctx(mesh, parallel: ParallelConfig, batch_axes=()) -> PRM.ShardCtx:
    """The step's sharding context: the ZeRO-3 weight gathers (int8 wire
    under ``fsdp_gather_weights``) and the batch axes of ``gather_rows``."""
    rules = default_rules(parallel)
    nofsdp = PRM.nofsdp_rules(rules, rules.get("batch"))
    return PRM.ShardCtx(mesh, rules, nofsdp,
                        gather_fsdp=parallel.fsdp and parallel.fsdp_gather_weights,
                        gather_wire=parallel.gather_wire, moe_grouped=parallel.moe_grouped,
                        batch=batch_axes)


def _map_state(fn, tree, shards):
    """``fn(leaf, LeafShard)`` over the leaves of a state tree whose layout
    ``shards`` gives (None: the whole subtree replicated, left as it is)."""
    if shards is None:
        return tree
    if isinstance(tree, dict):
        return {k: _map_state(fn, v, shards[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_state(fn, getattr(tree, f), getattr(shards, f))
                            for f in tree._fields))
    return fn(tree, shards)


def _axes_to_shards(abs_tree, axes_tree, mesh, rules):
    """A state tree's LeafShards from its whole shapes (``abs_tree``, on
    the meta device) and its logical axes (tuple leaves)."""
    if isinstance(abs_tree, dict):
        return {k: _axes_to_shards(v, axes_tree[k], mesh, rules) for k, v in abs_tree.items()}
    if hasattr(abs_tree, "_fields"):
        return type(abs_tree)(*(_axes_to_shards(getattr(abs_tree, f), getattr(axes_tree, f),
                                                mesh, rules) for f in abs_tree._fields))
    ps = _divisible(abs_tree.shape, logical_to_pspec(tuple(axes_tree), rules), mesh)
    return S.leaf_shard(mesh, tuple(abs_tree.shape), ps)


class StateShardings:
    """The TrainState's layout (``tree``: a TrainState whose leaves are
    LeafShard or None) and the collectives around it that the checkpoint
    manager and the Trainer need: whole leaves for a save, this rank's
    slices of a restored state, and decisions every rank takes together."""

    def __init__(self, mesh: S.Mesh, tree: TrainState):
        self.mesh, self.tree = mesh, tree

    def gather(self, state):
        """The whole state (every rank takes part)."""
        return _map_state(lambda x, sh: x if sh is None else sh.gather(x), state, self.tree)

    def local(self, state):
        """This rank's slices of a whole state."""
        return _map_state(lambda x, sh: x if sh is None else sh.take(x), state, self.tree)

    @property
    def is_writer(self) -> bool:
        return self.mesh.rank == 0

    def barrier(self) -> None:
        self.mesh.barrier()

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on one."""
        t = torch.tensor([float(bool(flag))], device=self.mesh.device)
        S.dist.all_reduce(t, op=S.dist.ReduceOp.MAX)
        return bool(t.item())

    def writer_value(self, value: int) -> int:
        """The writer's ``value`` on every rank."""
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.mesh.device)
        S.dist.broadcast(t, src=0)
        return int(t.item())


_LAST_KEY = re.compile(r"\['([^']*)'\]$")


class _DataParallel:
    """The collectives GSPMD inserts in the JAX step, for
    ``make_train_step(..., dist=)``:

    * ``prepare``: inside the gradient, each sharded leaf the loss reads
      whole is all-gathered (its gradient reduce-scattered back); the
      sharded weights of ``PRM.USE_WEIGHT_LEAVES`` stay local slices,
      registered with the step's ShardCtx, and ``use_weight`` gathers
      them in the compute dtype;
    * ``reduce``: the gradients summed over the batch's ranks (replicated
      leaves all-reduced; a sharded leaf's gradient was reduce-scattered
      over its shard's axes in the backward, and is all-reduced over the
      batch axes left, under ``pure_dp``), in f32, then divided by the
      number of ranks: the mean of each rank's gradient of its mean loss
      over equal rows. The loss and the loss function's float metrics
      take the same mean, in one collective. Against one rank the sum
      changes the rounding only: rank by rank, each rank's bf16-rounded
      weight gradient is added in f32 (tolerance in
      ``tests/test_torch_engine.py``);
    * ``shards``: the parameters' LeafShards, for the optimizer, the
      scaler's skip masks, the global norm and the quant-health scalars.
    """

    def __init__(self, mesh: S.Mesh, batch_axes: Tuple[str, ...], shards):
        self.mesh = mesh
        self.batch_axes = batch_axes
        self.group = mesh.group(batch_axes)
        self.size = mesh.size(batch_axes)
        self.shards = shards
        self._by_path = dict(tree_paths(shards))

    def prepare(self, params):
        at_use, out = [], {}
        for path, leaf in tree_paths(params):
            sh = self._by_path[path]
            if sh is not None and _LAST_KEY.search(path).group(1) in PRM.USE_WEIGHT_LEAVES:
                at_use.append((path, leaf, sh))
            elif sh is not None:
                leaf = S.Gather.apply(leaf, sh.dim, sh.group, sh.n)
            out[path] = leaf
        PRM.ShardCtx._current.register_weights(at_use)
        return tree_unflatten(params, out)

    def reduce(self, grads, loss, metrics):
        unused = PRM.ShardCtx._current.unused_weights()
        if unused:
            raise RuntimeError(f"sharded weights never reached use_weight: {unused}; "
                               "models.params.USE_WEIGHT_LEAVES names leaves the layers "
                               "read otherwise")
        R, out = self.size, {}
        for path, g in tree_paths(grads):
            sh = self._by_path[path]
            g = g.float().contiguous()
            left = self.batch_axes if sh is None else tuple(
                a for a in self.batch_axes if a not in sh.axes)
            if left:
                S.all_reduce_(g, self.mesh.group(left))
            out[path] = div(g, float(R)) if R > 1 else g
        grads = tree_unflatten(grads, out)
        keys = sorted(k for k, v in metrics.items()
                      if isinstance(v, torch.Tensor) and v.is_floating_point())
        parts = [loss] + [metrics[k] for k in keys]
        flat = torch.cat([p.float().reshape(-1) for p in parts])
        S.all_reduce_(flat, self.group)
        if R > 1:
            flat = div(flat, float(R))
        vals, at = [], 0
        for p in parts:
            vals.append(flat[at:at + p.numel()].reshape(p.shape).to(p.dtype))
            at += p.numel()
        return grads, vals[0], {**metrics, **dict(zip(keys, vals[1:]))}


@dataclasses.dataclass
class TrainEngine:
    bundle: Any
    train_cfg: TrainConfig
    parallel: ParallelConfig
    mesh: S.Mesh
    policy: QuantPolicy
    opt: Any
    scaler: Any
    rules: Dict
    specs: Dict                      # ParamSpec tree
    state_shardings: StateShardings
    param_shardings: Any             # LeafShard (or None) per parameter
    batch_spec: Dict                 # key -> (shape, dtype) of one global batch
    batch_shardings: Dict            # key -> pspec of the batch entry
    batch_axes: Tuple[str, ...]
    step_fn: Callable
    donate: bool

    def shard_ctx(self) -> PRM.ShardCtx:
        return make_shard_ctx(self.mesh, self.parallel, self.batch_axes)

    def step(self, state: TrainState, batch) -> tuple:
        """(state, this rank's batch from ``shard_batch``) -> (state,
        metrics), every metric the global batch's. The step builds a new
        state and keeps no reference to the one passed in (``donate``: the
        caller must not use it again, as JAX's donation enforces)."""
        with self.shard_ctx():
            return self.step_fn(state, batch)

    def init_state(self, seed: int = 0, params=None) -> TrainState:
        """This rank's slice of the state: the whole parameters drawn from
        ``seed`` in world 1's order (or ``params``, a whole tree of tensors
        or arrays, e.g. the JAX package's), sliced; the optimizer state of
        the slices; the scaler state, step and a generator seeded with
        ``seed`` replicated."""
        dev = self.mesh.device
        whole = (PRM.init_params(self.specs, seed, device=dev) if params is None
                 else tree_map(lambda a: torch.as_tensor(a).to(dev), params))
        local = tree_map(lambda t, sh: t if sh is None else sh.take(t), whole,
                         self.param_shardings)
        del whole
        return init_train_state(local, self.opt, self.scaler, seed=seed)

    def shard_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch, on the mesh's device. With
        ``microbatch_steps = M`` the rank holds its part of each global
        microbatch in order (global microbatch i is rows i B/M to
        (i+1) B/M, as the one-device step splits them)."""
        R, r = self.mesh.size(self.batch_axes), self.mesh.index(self.batch_axes)
        M = max(1, self.train_cfg.microbatch_steps)
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v).to(self.mesh.device)
            B, rest = v.shape[0], tuple(v.shape[1:])
            if B % (M * R):
                raise ValueError(f"batch entry {k!r} of {B} rows does not split into "
                                 f"{M} microbatches over {R} ranks")
            b = B // (M * R)
            out[k] = v.reshape((M, R, b) + rest)[:, r].reshape((M * b,) + rest).contiguous()
        return out

    def make_supervisor(self, state, data_fn, *, checkpoint_dir: str, config=None,
                        fault_plan=None, **kw):
        """The self-healing supervisor over this engine's step
        (``train/supervisor.py``): ``data_fn(j)`` gives the global batch
        of data index j, sharded here; checkpoints hold whole leaves, and
        every rank rewinds together on the global metrics."""
        from repro_torch.train.supervisor import TrainSupervisor
        return TrainSupervisor(self.step, state, lambda j: self.shard_batch(data_fn(j)),
                               checkpoint_dir=checkpoint_dir, config=config,
                               state_shardings=self.state_shardings, fault_plan=fault_plan,
                               **kw)

    def lower(self, batch_abs=None):
        raise NotImplementedError("lowering the step against abstract inputs is the dry-run, "
                                  "ROADMAP.md Queue 1 #10")


def _meta_tree(specs):
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def make_engine(model, train_cfg: TrainConfig, parallel: ParallelConfig, mesh: S.Mesh,
                batch_spec, *, policy: Optional[QuantPolicy] = None,
                donate: bool = True) -> TrainEngine:
    """Assemble the sharded train step for ``model`` on ``mesh``.

    ``model`` is an arch name, a config, or a prebuilt ModelBundle.
    ``batch_spec`` is one global batch (or anything with its entries'
    ``.shape`` and ``.dtype``). ``donate`` is accepted as in the JAX
    package (see ``TrainEngine.step``)."""
    from repro_torch.models import build
    if isinstance(model, str):
        from repro_torch.configs import get_config
        model = get_config(model)
    bundle = model if hasattr(model, "param_specs") else build(model)
    if tuple(mesh.axis_names) != tuple(parallel.mesh_axes):
        raise ValueError(f"mesh axes {mesh.axis_names} != ParallelConfig.mesh_axes "
                         f"{parallel.mesh_axes}")
    require_data_axes(parallel, mesh.mesh_shape)

    policy = policy or QuantPolicy.from_train_config(train_cfg)
    opt, scaler = make_train_setup(train_cfg)
    rules = default_rules(parallel)
    specs = bundle.param_specs
    pspecs = specs_to_pspecs(specs, mesh, rules)
    param_sh = tree_map(lambda s, ps: S.leaf_shard(mesh, s.shape, ps), specs, pspecs)
    opt_abs = opt.init(_meta_tree(specs))
    opt_sh = (None if opt.state_logical_axes is None   # protocol not implemented: replicate
              else _axes_to_shards(opt_abs, opt.state_logical_axes(specs), mesh, rules))
    state_sh = StateShardings(mesh, TrainState(param_sh, opt_sh, None, None, None))

    batch = rules["batch"]
    batch_axes = batch if isinstance(batch, tuple) else (batch,)
    spec = {k: (tuple(v.shape), v.dtype) for k, v in batch_spec.items()}
    shardings = {k: (batch_axes,) + (None,) * (len(s) - 1) for k, (s, _) in spec.items()}
    dist = _DataParallel(mesh, batch_axes, param_sh)
    step_fn = make_train_step(bundle, policy, parallel, train_cfg, opt, scaler, dist=dist)
    return TrainEngine(bundle=bundle, train_cfg=train_cfg, parallel=parallel, mesh=mesh,
                       policy=policy, opt=opt, scaler=scaler, rules=rules, specs=specs,
                       state_shardings=state_sh, param_shardings=param_sh, batch_spec=spec,
                       batch_shardings=shardings, batch_axes=batch_axes, step_fn=step_fn,
                       donate=donate)


def n_partitioned(engine: TrainEngine) -> Tuple[int, int]:
    """(parameter tensors split over more than one rank, all of them)."""
    shards = [sh for _, sh in tree_paths(engine.param_shardings)]
    return sum(1 for sh in shards if sh is not None and sh.split), len(shards)


class _ShapeMesh:
    """A mesh shape alone (``_divisible`` reads only ``mesh.shape``)."""

    def __init__(self, axes, shape):
        self.shape = dict(zip(axes, shape))


def predicted_state_bytes(bundle, train_cfg: TrainConfig, parallel: ParallelConfig,
                          mesh_shape) -> Dict[str, float]:
    """Bytes of the parameters and the optimizer state one rank would
    hold on a mesh of ``mesh_shape`` (``parallel.mesh_axes``): each leaf's
    whole size over the ranks its pspec splits it across. A prediction
    from the leaf sizes, no mesh built."""
    mesh = _ShapeMesh(parallel.mesh_axes, mesh_shape)
    rules = default_rules(parallel)

    def per_rank(shape, dtype, logical):
        ps = _divisible(shape, logical_to_pspec(tuple(logical), rules), mesh)
        n = math.prod(mesh.shape[a] for e in ps for a in S._axes(e))
        return math.prod(shape) * torch.empty((), dtype=dtype).element_size() / n

    specs = bundle.param_specs
    params = sum(per_rank(s.shape, s.dtype, s.logical) for s in tree_leaves(specs))
    opt, _ = make_train_setup(train_cfg)
    opt_abs = opt.init(_meta_tree(specs))
    axes = opt.state_logical_axes(specs)

    def walk(a, ax):
        if isinstance(a, dict):
            return sum(walk(v, ax[k]) for k, v in a.items())
        if hasattr(a, "_fields"):
            return sum(walk(getattr(a, f), getattr(ax, f)) for f in a._fields)
        return per_rank(tuple(a.shape), a.dtype, ax)

    state = walk(opt_abs, axes)
    return {"params": params, "opt_state": state, "total": params + state}
