"""ParamSpec machinery: one declarative tree drives parameter init and
the sharding rules.

The PyTorch counterpart of ``repro/models/params.py``. Parameter trees are
nested dicts of tensors with the JAX package's leaf names, leading group
dimension and ``(n_in, m_out)`` weight layout, so ``from_numpy_tree``
carries the JAX package's parameters across unchanged.

The rule half (``default_rules``, ``logical_to_pspec``, ``_divisible``,
``specs_to_pspecs``, ``nofsdp_rules``) is the JAX package's, in plain
Python: a pspec is a tuple with one entry per dim, None, an axis name or a
tuple of names, entry for entry JAX's ``PartitionSpec``. ``ShardCtx``,
``constrain`` and ``use_weight`` carry the sharded step's context to the
layers (``train/engine.py``): on the data axes ``constrain`` has nothing
to do (a local tensor is already its shard), and ``use_weight`` is where
a ZeRO-3 weight is gathered.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quantization import div
from repro_torch.distributed import sharding as S


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # logical axis name per dim
    init: str = "normal"                 # normal|zeros|ones|constant|fan_in
    scale: float = 0.02                  # stddev for normal / value for constant
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of one or more dict trees of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_paths(tree, prefix: str = ""):
    """(path, leaf) pairs in sorted key order, the order ``jax.tree``
    flattens dicts in (sums over leaves add in the same order); ``path``
    is JAX's ``keystr`` form, ``['blocks']['pos0']['attn']['wq']``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like, by_path: dict, prefix: str = ""):
    """A tree shaped like ``like`` whose leaves come from ``by_path``
    (keyed as ``tree_paths`` names them)."""
    if isinstance(like, dict):
        return {k: tree_unflatten(v, by_path, f"{prefix}[{k!r}]") for k, v in like.items()}
    return by_path[prefix]


def tree_from_leaves(like, leaves):
    """A tree shaped like ``like`` with ``leaves`` in ``tree_leaves`` order."""
    return tree_unflatten(like, dict(zip((p for p, _ in tree_paths(like)), leaves)))


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device. Asking for the card on a host that has
    none raises: an entry point never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def init_params(specs, generator: torch.Generator | int = 0, *, device="cuda"):
    """Random parameters for a spec tree, drawn from ``generator`` (a
    ``torch.Generator`` on ``device``, or an int seed for one) in sorted
    leaf order. Same init kinds and scales as the JAX package; the numbers
    differ, since torch's generator is not JAX's threefry."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)

    def one(spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "constant":
            return torch.full(spec.shape, spec.scale, dtype=spec.dtype, device=device)
        std = spec.scale
        if spec.init == "fan_in":     # scale multiplies 1/sqrt(fan_in)
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = spec.scale / math.sqrt(fan_in)
        w = torch.randn(spec.shape, dtype=spec.dtype, device=device, generator=generator)
        return w.mul_(std)

    # draw in sorted leaf order so the stream does not depend on dict order
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return one(tree)

    return walk(specs)


def from_numpy_tree(tree, device="cuda"):
    """The JAX package's parameter tree, as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), as the port's tree of tensors on
    ``device``: same leaf names, same shapes, same values."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device), tree)


# ---------------------------------------------------------------------------
# logical-axis -> mesh-axis rules (MaxText-style); copies of the JAX rules
# ---------------------------------------------------------------------------

def default_rules(parallel) -> Dict[str, object]:
    """Map logical param/activation axes onto mesh axes.

    ``model`` carries TP (heads / ff / experts / vocab); ``data`` (+``pod``)
    carries DP; with fsdp=True the embed axis of weights is sharded over
    data as well (ZeRO-3-style parameter sharding). ``pure_dp`` folds the
    model axis into data parallelism: the batch shards over every mesh
    axis and no tensor dim maps to ``model``."""
    data = parallel.data_axes            # ("data",) or ("pod", "data")
    if parallel.pure_dp:
        all_axes = tuple(parallel.mesh_axes)
        rules = {
            "batch": all_axes, "embed": None, "seq": None, "heads": None,
            "kv_heads": None, "head_dim": None, "mlp": None, "experts": None,
            "expert_capacity": all_axes, "vocab": None, "layers": None,
            "conv": None, "state": None, "lora": None, "frames": None,
        }
        if parallel.fsdp:
            rules["embed"] = data        # ZeRO shards storage over data
        return rules
    rules = {
        "batch": data,
        "embed": None,
        "seq": None,
        "heads": "model",
        "kv_heads": ("model" if getattr(parallel, "shard_kv_heads", True) else None),
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "expert_capacity": data,
        "vocab": "model",
        "layers": None,
        "conv": None,
        "state": None,
        "lora": None,
        "frames": None,
    }
    if parallel.fsdp:
        rules["embed"] = data            # ZeRO-3: shard the big axis over data
    if parallel.sequence_parallel:
        rules["seq"] = "model"
    return rules


def _entry(mesh_axis):
    """A pspec entry as JAX's ``PartitionSpec`` holds it: a tuple of one
    axis name is that name."""
    if isinstance(mesh_axis, tuple) and len(mesh_axis) == 1:
        return mesh_axis[0]
    return mesh_axis


def logical_to_pspec(logical: Tuple[Optional[str], ...], rules) -> tuple:
    """A pspec from logical axis names; a mesh axis appears once per
    pspec, so a later duplicate is left unsharded."""
    axes = []
    used = set()
    for name in logical:
        if name is None:
            axes.append(None)
            continue
        mesh_axis = rules.get(name)
        parts = (mesh_axis if isinstance(mesh_axis, tuple)
                 else (mesh_axis,)) if mesh_axis is not None else ()
        if mesh_axis is None or any(p in used for p in parts):
            axes.append(None)
        else:
            axes.append(_entry(mesh_axis))
            used.update(parts)
    return tuple(axes)


def _divisible(shape, pspec, mesh) -> tuple:
    """Drop shardings that don't divide the dim (e.g. kv_heads=1 over 16).
    ``mesh`` is anything with JAX's ``mesh.shape`` mapping of axis sizes."""
    out = []
    for dim, ax in zip(shape, tuple(pspec) + (None,) * (len(shape) - len(pspec))):
        if ax is None:
            out.append(None)
            continue
        size = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            size *= mesh.shape[a]
        out.append(ax if dim % size == 0 else None)
    return tuple(out)


def specs_to_pspecs(specs, mesh, rules):
    """The pspec of every ParamSpec of a tree."""
    return tree_map(lambda s: _divisible(s.shape, logical_to_pspec(s.logical, rules), mesh),
                    specs)


def nofsdp_rules(rules: dict, data_axes) -> dict:
    """The same rule table with the FSDP (data-over-embed) mapping removed."""
    out = dict(rules)
    if out.get("embed") == data_axes or out.get("embed") in ("data",):
        out["embed"] = None
    return out


# ---------------------------------------------------------------------------
# the sharded step's context: activation constraints and ZeRO-3 gathers
# ---------------------------------------------------------------------------

#: the leaves the port's layers hand to ``use_weight`` (attention, MLP and
#: the experts' stacked MLP, the router, the patch embedding, an untied
#: head, a frontend's projection, Mamba's three projections, RWKV's
#: time-mix and channel-mix projections): a sharded one reaches the layer
#: as its local slice and is gathered there, in the dtype the layer asks
#: for; the engine gathers every other sharded leaf (the LoRAs, the mixes,
#: the conv) whole before the loss
USE_WEIGHT_LEAVES = frozenset({"wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down",
                               "w_router", "patch_embed", "head", "frontend_proj",
                               "w_in", "w_x_proj", "w_out",
                               "wr", "wg", "w_key", "w_value", "w_receptance"})


class ShardCtx:
    """Carries the mesh and the rules to the layers of one sharded step:
    ``with ShardCtx(...): loss_fn(...)``. Outside one (the plain step) the
    helpers below change nothing but ``use_weight``'s cast.

    The JAX fields: ``gather_fsdp`` (the JAX package's explicit weight
    gather, ``ParallelConfig.fsdp and fsdp_gather_weights``) and
    ``gather_wire`` ("bf16" or "int8", the int8 wire applied under
    ``gather_fsdp`` only, as in JAX). The port's own: ``batch``, the mesh
    axes the batch rows are split over (``gather_rows``), and the weights
    registered for the step (``register_weights``): sharded leaves that
    reach ``use_weight`` as their local slices, found by their storage (a
    layer's weight is a view of its stacked leaf)."""
    _current: Optional["ShardCtx"] = None

    def __init__(self, mesh, rules: Optional[dict], rules_nofsdp: Optional[dict] = None,
                 gather_fsdp: bool = False, gather_wire: str = "bf16",
                 moe_grouped: bool = True, batch: Tuple[str, ...] = ()):
        self.mesh = mesh
        self.rules = rules
        self.rules_nofsdp = rules_nofsdp or rules
        self.gather_fsdp = gather_fsdp
        self.gather_wire = gather_wire
        self.moe_grouped = moe_grouped
        self.batch = tuple(batch)
        self._weights: Dict[int, tuple] = {}
        self._used: set = set()

    def constrain(self, x: torch.Tensor, logical: Tuple[Optional[str], ...]) -> torch.Tensor:
        """A no-op: on the data axes a local tensor already is its shard
        (tensor and sequence parallelism, which would move it, are
        ROADMAP.md Queue 1 #13)."""
        return x

    def register_weights(self, leaves) -> None:
        """``leaves``: (path, local tensor, LeafShard) of the sharded
        leaves the layers will hand to ``use_weight`` this step."""
        self._weights = {t.untyped_storage().data_ptr(): (path, tuple(t.shape), sh)
                         for path, t, sh in leaves}
        self._used = set()

    def unused_weights(self) -> list:
        """Registered weights no ``use_weight`` call has gathered."""
        return sorted(p for k, (p, _, _) in self._weights.items() if k not in self._used)

    def weight_shard(self, w: torch.Tensor):
        """(LeafShard, the split dim of ``w``) when ``w`` is a registered
        leaf or a view of one that drops its leading (layer) dims; else
        None."""
        if not self._weights:
            return None
        key = w.untyped_storage().data_ptr()
        hit = self._weights.get(key)
        if hit is None:
            return None
        path, shape, sh = hit
        lead = len(shape) - w.dim()
        if lead < 0 or tuple(w.shape) != shape[lead:] or sh.dim < lead:
            raise ValueError(f"use_weight got a {tuple(w.shape)} view of the sharded leaf "
                             f"{path} {shape}: only its layers (leading dims) may be indexed")
        self._used.add(key)
        return sh, sh.dim - lead

    def __enter__(self):
        self._prev = ShardCtx._current
        ShardCtx._current = self
        return self

    def __exit__(self, *a):
        ShardCtx._current = self._prev


def constrain(x: torch.Tensor, logical: Tuple[Optional[str], ...]) -> torch.Tensor:
    ctx = ShardCtx._current
    if ctx is None:
        return x
    return ctx.constrain(x, logical)


def _wire_int8(y: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    """The reference's int8 wire codes: round(y_f32 * (127 / absmax)),
    division first, round half to even."""
    return torch.round(y.float() * div(127.0, absmax)).to(torch.int8)


class _UseWeight(torch.autograd.Function):
    """``w`` cast to ``dtype``, through the int8 wire when ``int8``, and
    gathered along ``dim`` over the shard's group when ``shard`` is given.
    Backward: the gradient of the cast weight widened to ``w``'s dtype and
    reduce-scattered (summed) to this rank's slice; through the int8 wire
    the same (straight-through)."""

    @staticmethod
    def forward(ctx, w, dtype, int8, shard, dim):
        ctx.in_dtype, ctx.shard, ctx.dim = w.dtype, shard, dim
        y = w if dtype is None else w.to(dtype)
        if not int8:
            return S.gather_dim(y, dim, shard.group, shard.n)
        absmax = torch.amax(torch.abs(y.float()))
        if shard is not None:            # the codes of the whole weight
            S.all_reduce_(absmax, shard.group, S.dist.ReduceOp.MAX)
        absmax = torch.clamp_min(absmax, 1e-12)
        q = _wire_int8(y, absmax)
        if shard is not None:            # int8 on the wire
            q = S.gather_dim(q, dim, shard.group, shard.n)
        return (q.float() * div(absmax, 127.0)).to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        g = g.to(ctx.in_dtype)
        if ctx.shard is not None:
            g = S.scatter_dim(g, ctx.dim, ctx.shard.group, ctx.shard.n)
        return g, None, None, None, None


def use_weight(w: torch.Tensor, logical: Tuple[Optional[str], ...] = (),
               dtype=None) -> torch.Tensor:
    """Prepare a weight for a matmul: cast to ``dtype`` when one is given.

    The layers pass the compute dtype exactly where the JAX layers do, so
    the f32 weight gradient of ``quant_linear`` is cast to that dtype and
    widened back on its way to the f32 master: rounded through bf16, as
    ``jax.grad`` rounds it in the JAX package.

    Inside a sharded step (``ShardCtx``) a ZeRO-3 weight arrives as its
    local slice: it is cast first (the wire carries the compute dtype) and
    all-gathered, and the backward reduce-scatters its gradient in the
    master's dtype, f32, summing each rank's bf16-rounded gradient. The
    port gathers under ``fsdp`` whether or not ``fsdp_gather_weights`` is
    set: the JAX package's choice between gathering weights and letting
    GSPMD partial-sum activations is a layout XLA picks, not another
    function. Under ``gather_fsdp`` with ``gather_wire="int8"`` every weight
    crosses the wire as the reference's tensor-wise int8 codes: the absmax
    is reduced (MAX) over the shards first, so the codes are those of the
    whole weight, ``round(w_f32 * (127 / absmax))`` dequantized as
    ``q * (absmax / 127)`` and cast to the weight's dtype, the reference's
    arithmetic bit for bit. Its gradient is straight-through (the bf16
    wire's), which is what the reference's docstring describes; the
    reference's ``jax.grad`` through its ``astype(int8)`` is zero off the
    absmax element (ROADMAP.md Queue 3 #4 and #5). ``logical`` is kept so
    call sites read as in the JAX package."""
    ctx = ShardCtx._current
    if ctx is None or ctx.mesh is None:
        return w if dtype is None else w.to(dtype)
    hit = ctx.weight_shard(w)
    int8 = ctx.gather_fsdp and ctx.gather_wire == "int8"
    if hit is None and not int8:
        return w if dtype is None else w.to(dtype)
    shard, dim = hit if hit is not None else (None, None)
    return _UseWeight.apply(w, dtype, int8, shard, dim)


def int8_wire(w: torch.Tensor) -> torch.Tensor:
    """The int8 wire's quantize-dequantize of a whole weight, with the
    straight-through gradient, on one device: what ``use_weight`` computes
    under ``gather_wire="int8"`` with no shard (the plain reference of the
    sharded gather)."""
    return _UseWeight.apply(w, None, True, None, None)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of a batch-split activation (CLIP's
    embeddings before the contrastive loss): all-gathered over the batch
    axes, the gradient reduce-scattered (summed) back. Every rank then
    computes the same global loss, and the engine's mean over ranks of the
    summed gradients counts each row once. Outside a sharded step, ``x``."""
    ctx = ShardCtx._current
    if ctx is None or not ctx.batch:
        return x
    m = ctx.mesh
    return S.Gather.apply(x, 0, m.group(ctx.batch), m.size(ctx.batch))
