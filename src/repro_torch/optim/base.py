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

Updates run under ``torch.no_grad()`` and return new tensors, as the JAX
functions return new arrays; every decision stays on the device (no host
sync per tensor). Trees are walked with ``models.params``' helpers.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models.params import tree_leaves, tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]   # step -> lr (f32 tensor)


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]   # (params, state, grads, skip_mask=None)


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


def tree_finite_mask(tree):
    """Per-tensor 'all finite' predicate (False: an Inf or NaN is there)."""
    return tree_map(lambda g: torch.isfinite(g.float()).all(), tree)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)])))
