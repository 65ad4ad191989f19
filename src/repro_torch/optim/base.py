"""Optimizer protocol and helpers (the JAX package's ``repro/optim/base.py``,
over the port's parameter trees).

An Optimizer is a pair of plain functions:

    state                = opt.init(params)
    params', state', aux = opt.update(params, state, grads, skip_mask=None)

* ``params`` are the f32 master weights: nested dicts of tensors, the JAX
  package's tree layout.
* ``skip_mask`` is an optional tree of 0-d bool tensors (True = skip this
  tensor's update this step), the hook of the paper's §3.6 tensor-level
  loss scaler.
* ``aux`` holds diagnostics (per-tensor RMS_t, the lr applied).
* ``shards`` (optional) is a tree of ``distributed.sharding.LeafShard``
  (or None) per parameter, the sharded engine's: each leaf is then this
  rank's slice, and every reduction over a whole tensor (StableAdamW's
  RMS_t, AdaFactor's factored means and update RMS) sums its parts over
  the ranks. Without it, or at one rank per leaf, the update is the plain
  one bit for bit.
* ``state_logical_axes(param_specs)`` maps a tree of ParamSpecs to a tree
  shaped like ``init``'s state whose leaves are logical-axis tuples: the
  spec the engine turns into each state leaf's pspec, so optimizer state
  shards like (or derived from) its params. ``()`` means replicated.

Updates run under ``torch.no_grad()`` and return new tensors, as the JAX
functions return new arrays; every decision stays on the device (no host
sync per tensor). Trees are walked with ``models.params``' helpers.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.distributed import sharding as S
from repro_torch.models.params import tree_from_leaves, tree_leaves, tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]   # step -> lr (f32 tensor)


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]   # (params, state, grads, skip_mask=None, shards=None)
    state_logical_axes: Optional[Callable[[Any], Any]] = None


def param_logical_axes(param_specs):
    """Per-param logical axes, the building block of state_logical_axes."""
    return tree_map(lambda s: tuple(s.logical), param_specs)


def shard_leaves(tree, shards) -> list:
    """The LeafShard (or None) of each leaf of ``tree``, in leaf order."""
    if shards is None:
        return [None] * len(tree_leaves(tree))
    return tree_leaves(tree_map(lambda _, sh: sh, tree, shards))


def default_wd_mask(params):
    """Decay only matrices (ndim >= 2); biases, norm gains, layer-scale
    vectors and scalars are excluded (OpenCLIP's default). Host bools: the
    shapes decide."""
    return tree_map(lambda p: p.dim() >= 2, params)


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def apply_skip_mask(skip, new, old):
    """Per-tensor conditional update: where skip is True keep ``old``."""
    if skip is None:
        return new
    return tree_map(lambda s, n, o: torch.where(s, o, n), skip, new, old)


def tree_finite_mask(tree, shards=None):
    """Per-tensor 'all finite' predicate (False: an Inf or NaN is there),
    over the whole tensor where ``shards`` splits it, so every rank skips
    the same tensors."""
    if shards is None:
        return tree_map(lambda g: torch.isfinite(g.float()).all(), tree)
    leaves = [torch.isfinite(g.float()).all() for g in tree_leaves(tree)]
    flags = S.reduce_scalars([f.float() for f in leaves], shard_leaves(tree, shards), "min")
    return tree_from_leaves(tree, [f > 0 for f in flags])


def global_norm(tree, shards=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, each split leaf's summed
    over its ranks (``shards``)."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    if shards is not None:
        sq = S.reduce_scalars(sq, shard_leaves(tree, shards), "sum")
    return torch.sqrt(torch.sum(torch.stack(sq)))
