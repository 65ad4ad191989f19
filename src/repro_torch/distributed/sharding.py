"""Sharded leaves on the data axes: the port's counterpart of GSPMD's
placement, with the collectives that GSPMD inserts silently written out.

* ``Mesh`` is a ``torch.distributed`` ``DeviceMesh`` with the JAX
  package's axis names (``mesh.shape`` maps each name to its size, as a JAX
  mesh's does), plus one process group for every set of two or more of its
  axes, since a pspec entry may name ``("pod", "data")`` or every axis.
* ``LeafShard`` is one leaf's place on the mesh: its whole shape, its pspec
  (``models.params.specs_to_pspecs``) and the one dim split over data axes,
  if any. A sharded leaf is held as a plain local tensor, this rank's
  slice, beside its LeafShard; not as a ``DTensor``, because the kernels
  take raw pointers through ``ctypes`` (``kernels/build.py``), which a
  DTensor cannot hand over.
* ``gather_dim``/``scatter_dim`` and the autograd form ``Gather`` (an
  all-gather forward, a summing reduce-scatter backward) move a split dim;
  ``mean``, ``tree_mean`` and ``reduce_scalars`` take a whole-tensor
  reduction of a local slice.

A collective over a group of one rank still runs (it is a copy), so the
engine's path is the same at every world size. A reduction that would
change its bits when taken in two parts (a mean as a local sum, an
all-reduce and one division) takes that form only where the dim is split
over more than one rank: a world of one computes what the plain step does,
bit for bit.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.quantization import div

#: the mesh axes that carry data parallelism (``ParallelConfig.data_axes``)
DATA_AXES = ("pod", "data")

# the one-tensor all-gather and reduce-scatter under their newer names
# where this torch has them (the older ones are deprecated there)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _axes(entry) -> Tuple[str, ...]:
    """A pspec entry (None, an axis name or a tuple of names) as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class Mesh:
    """A DeviceMesh with JAX's axis names and a group for each axis set.

    Built collectively by every rank (``launch/mesh.py``). ``group(axes)``
    is the process group over ``axes`` (in mesh order) holding this rank,
    whose ranks are ordered row-major over those axes, the order in which a
    JAX pspec entry of several axes lays out a dim's shards."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.mesh_shape = tuple(int(s) for s in device_mesh.mesh.shape)
        self.shape = dict(zip(self.axis_names, self.mesh_shape))
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if device_mesh.device_type == "cuda" else torch.device("cpu"))
        self.coordinate = dict(zip(self.axis_names, device_mesh.get_coordinate()))
        ranks = device_mesh.mesh
        self._groups: Dict[Tuple[str, ...], Any] = {}
        nd = len(self.axis_names)
        for k in range(2, nd + 1):
            for dims in itertools.combinations(range(nd), k):
                rest = [d for d in range(nd) if d not in dims]
                size = math.prod(self.mesh_shape[d] for d in dims)
                rows = ranks.permute(rest + list(dims)).reshape(-1, size)
                mine, _ = dist.new_subgroups_by_enumeration([r.tolist() for r in rows])
                self._groups[tuple(self.axis_names[d] for d in dims)] = mine

    @property
    def rank(self) -> int:
        return dist.get_rank()

    def _ordered(self, axes) -> Tuple[str, ...]:
        axes = _axes(axes)
        if list(axes) != sorted(axes, key=self.axis_names.index):
            raise ValueError(f"axes {axes} are not in the mesh's order {self.axis_names}")
        return axes

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def index(self, axes) -> int:
        """This rank's place along ``axes``, row-major (the shard it holds)."""
        i = 0
        for a in self._ordered(axes):
            i = i * self.shape[a] + self.coordinate[a]
        return i

    def group(self, axes):
        axes = self._ordered(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._groups[axes]

    def barrier(self):
        dist.barrier()


# ---------------------------------------------------------------------------
# one leaf on the mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafShard:
    """A leaf's whole ``shape``, its ``pspec``, and the dim split over the
    data ``axes`` into ``n`` equal slices, of which this rank holds slice
    ``index`` (``dim`` None: the leaf is replicated over the data axes)."""
    shape: Tuple[int, ...]
    pspec: Tuple
    dim: Optional[int] = None
    axes: Tuple[str, ...] = ()
    n: int = 1
    index: int = 0
    group: Any = None

    @property
    def split(self) -> bool:
        """More than one rank holds a part of the leaf."""
        return self.dim is not None and self.n > 1

    def take(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole leaf, in memory of its own."""
        if self.dim is None:
            return whole
        size = self.shape[self.dim] // self.n
        return whole.narrow(self.dim, self.index * size, size).clone()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's slice (no gradient)."""
        if self.dim is None:
            return local
        return gather_dim(local, self.dim, self.group, self.n)

    def drop(self, dim: int) -> Optional["LeafShard"]:
        """The shard of a reduction of this leaf over ``dim``: replicated
        when ``dim`` was the split one, else the same split one dim lower
        past it."""
        dim %= len(self.shape)
        shape = self.shape[:dim] + self.shape[dim + 1:]
        pspec = self.pspec[:dim] + self.pspec[dim + 1:]
        if self.dim is None or self.dim == dim:
            return LeafShard(shape, pspec)
        return dataclasses.replace(self, shape=shape, pspec=pspec,
                                   dim=self.dim - (self.dim > dim))


def leaf_shard(mesh: Mesh, shape, pspec) -> Optional[LeafShard]:
    """The LeafShard of a leaf of whole ``shape`` laid out by ``pspec`` on
    ``mesh``, or None where no dim maps to a data axis. An entry of the
    ``model`` axis alone must be of size 1: tensor parallelism is
    ROADMAP.md Queue 1 #13."""
    split = []
    for d, entry in enumerate(pspec):
        axes = _axes(entry)
        if not axes:
            continue
        if any(a in DATA_AXES for a in axes):
            split.append((d, axes))
        elif mesh.size(axes) > 1:
            raise NotImplementedError(
                f"a leaf of shape {tuple(shape)} splits dim {d} over {axes} "
                f"({mesh.size(axes)} ranks): tensor parallelism over 'model' is "
                "ROADMAP.md Queue 1 #13")
    if not split:
        return None
    if len(split) > 1:
        raise NotImplementedError(f"a leaf of shape {tuple(shape)} splits two dims {split}: "
                                  "ROADMAP.md Queue 1 #13")
    d, axes = split[0]
    return LeafShard(tuple(shape), tuple(pspec), d, axes, mesh.size(axes),
                     mesh.index(axes), mesh.group(axes))


# ---------------------------------------------------------------------------
# collectives along a dim
# ---------------------------------------------------------------------------

def gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """All-gather ``x`` along ``dim``: rank r's slice lands at r."""
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]), dtype=x.dtype, device=x.device)
    _all_gather(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def scatter_dim(g: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """Reduce-scatter (sum) ``g`` along ``dim``: this rank's slice of the
    sum over the group."""
    gt = g.movedim(dim, 0).contiguous()
    out = torch.empty((gt.shape[0] // n,) + tuple(gt.shape[1:]), dtype=g.dtype, device=g.device)
    _reduce_scatter(out, gt, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous()


class Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; the gradient reduce-scattered
    (summed over the group) backward: each rank's part of every rank's use.
    The weights of ``models.params.use_weight``, a sharded leaf used whole
    and CLIP's global batch of embeddings go through it."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim(g, ctx.dim, ctx.group, ctx.n), None, None, None


class AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over ``group``, forward; backward, the gradient's
    sum over the group: each rank's loss reads the same sum, so a rank's
    part of it carries every rank's gradient (the MoE aux loss's global
    means)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over ``group``; returns ``x``."""
    dist.all_reduce(x, op=op, group=group)
    return x


# ---------------------------------------------------------------------------
# whole-tensor reductions of a local slice
# ---------------------------------------------------------------------------

def _reduced_dims(ndim: int, dim) -> Tuple[int, ...]:
    if dim is None:
        return tuple(range(ndim))
    return tuple(d % ndim for d in ((dim,) if isinstance(dim, int) else dim))


def _splits(shard: Optional[LeafShard], x: torch.Tensor, dim) -> bool:
    return (shard is not None and shard.split
            and shard.dim in _reduced_dims(x.dim(), dim))


def mean(x: torch.Tensor, shard: Optional[LeafShard], dim=None, keepdim=False) -> torch.Tensor:
    """``torch.mean`` of the whole tensor whose local slice is ``x`` (laid
    out by ``shard``), over ``dim`` (None: every dim). Off the split dim,
    or unsplit, it is ``torch.mean`` itself."""
    if not _splits(shard, x, dim):
        return torch.mean(x) if dim is None else torch.mean(x, dim=dim, keepdim=keepdim)
    dims = _reduced_dims(x.dim(), dim)
    s = torch.sum(x, dim=dims, keepdim=keepdim)
    all_reduce_(s, shard.group)
    return div(s, float(math.prod(x.shape[d] for d in dims) * shard.n))


_OPS = {"sum": (torch.sum, dist.ReduceOp.SUM), "max": (torch.amax, dist.ReduceOp.MAX),
        "min": (torch.amin, dist.ReduceOp.MIN)}


def reduce_scalars(values: Sequence[torch.Tensor], shards: Sequence[Optional[LeafShard]],
                   op: str = "sum") -> list:
    """Per leaf 0-d partial results (sums, maxima or minima over a local
    slice) made whole: those of split leaves all-reduced with ``op``, one
    collective per group, the others returned as they are."""
    out = list(values)
    by_group: Dict[int, list] = {}
    for i, sh in enumerate(shards):
        if sh is not None and sh.split:
            by_group.setdefault(id(sh.group), []).append(i)
    for idx in by_group.values():
        stacked = torch.stack([out[i].float() for i in idx])
        all_reduce_(stacked, shards[idx[0]].group, _OPS[op][1])
        for j, i in enumerate(idx):
            out[i] = stacked[j].to(values[i].dtype)
    return out


def tree_mean(leaves: Sequence[torch.Tensor], shards: Sequence[Optional[LeafShard]]) -> list:
    """The whole-tensor ``torch.mean`` of each leaf: unsplit leaves by
    ``torch.mean`` itself, split ones as their sums all-reduced (one
    collective per group) over the whole count."""
    sums = [torch.sum(x) if sh is not None and sh.split else torch.mean(x)
            for x, sh in zip(leaves, shards)]
    sums = reduce_scalars(sums, shards, "sum")
    return [div(s, float(x.numel() * sh.n)) if sh is not None and sh.split else s
            for s, x, sh in zip(sums, leaves, shards)]
