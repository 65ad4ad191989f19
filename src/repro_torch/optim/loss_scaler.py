"""Loss scaling for fp16 training (paper §2.1 and §3.6); the port of
``repro/optim/loss_scaler.py``.

* ``DynamicLossScaler``: the PyTorch-default baseline the paper critiques
  (global Inf/NaN check, whole-network skip, halve on overflow, double
  after ``growth_interval`` clean steps).
* ``FixedTensorLevelScaler``: the paper's recommendation, a fixed scale and
  a per-tensor skip of only the tensor that overflowed.
* ``NoOpScaler``: bf16/f32, no scaling, still a per-tensor skip of
  non-finite gradients.

States are 0-d tensors on the parameters' device; every decision stays
there (no host sync).

    scaled_loss = scaler.scale(loss, state)
    grads, skip_mask, state, stats = scaler.unscale(grads, state, shards=None)

``shards`` (the sharded engine's LeafShard tree) makes each finite mask a
whole tensor's, so every rank skips the same tensors and the dynamic
scaler takes the same whole-network decision everywhere.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.quantization import div
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim.base import tree_finite_mask


class ScalerState(NamedTuple):
    scale: torch.Tensor       # f32 scalar
    good_steps: torch.Tensor  # int32, consecutive overflow-free steps


def _state(scale: float, device) -> ScalerState:
    return ScalerState(torch.full((), scale, dtype=torch.float32, device=device),
                       torch.zeros((), dtype=torch.int32, device=device))


def _n_true(mask) -> torch.Tensor:
    return torch.sum(torch.stack([s.to(torch.int32) for s in tree_leaves(mask)]))


class FixedTensorLevelScaler:
    """Paper §3.6: fixed scale + tensor-level skip."""

    def __init__(self, init_scale: float = 65536.0):
        self.init_scale = init_scale

    def init(self, device="cpu") -> ScalerState:
        return _state(self.init_scale, device)

    def scale(self, loss, state: ScalerState):
        return loss * state.scale.to(loss.dtype)

    @torch.no_grad()
    def unscale(self, grads, state: ScalerState, shards=None):
        finite = tree_finite_mask(grads, shards)
        skip_mask = tree_map(torch.logical_not, finite)
        inv = div(1.0, state.scale)
        grads = tree_map(lambda g, f: torch.where(f, g.float() * inv, 0.0), grads, finite)
        # the scale never changes; good_steps kept for symmetric logging
        new_state = ScalerState(state.scale, state.good_steps + 1)
        return grads, skip_mask, new_state, {"n_skipped_tensors": _n_true(skip_mask),
                                             "loss_scale": state.scale}


class DynamicLossScaler:
    """PyTorch-default dynamic scaler (global skip): the baseline."""

    def __init__(self, init_scale: float = 65536.0, growth_interval: int = 2000,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 max_scale: float = 2.0 ** 24):
        self.init_scale = init_scale
        self.growth_interval = growth_interval
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.max_scale = max_scale

    def init(self, device="cpu") -> ScalerState:
        return _state(self.init_scale, device)

    def scale(self, loss, state: ScalerState):
        return loss * state.scale.to(loss.dtype)

    @torch.no_grad()
    def unscale(self, grads, state: ScalerState, shards=None):
        finite = tree_finite_mask(grads, shards)
        all_finite = torch.all(torch.stack(tree_leaves(finite)))
        inv = div(1.0, state.scale)
        grads = tree_map(lambda g: g.float() * inv, grads)
        # global skip: every tensor skipped if any overflowed
        skip_mask = tree_map(lambda g: torch.logical_not(all_finite), grads)
        good = torch.where(all_finite, state.good_steps + 1, 0).to(torch.int32)
        grew = good >= self.growth_interval
        new_scale = torch.where(
            all_finite,
            torch.where(grew, torch.clamp_max(state.scale * self.growth_factor,
                                              self.max_scale), state.scale),
            state.scale * self.backoff_factor)
        good = torch.where(grew, 0, good).to(torch.int32)
        return grads, skip_mask, ScalerState(new_scale, good), {
            "n_skipped_tensors": torch.where(all_finite, 0, 1).to(torch.int32),
            "loss_scale": new_scale}


class NoOpScaler:
    """bf16/f32: no scaling; non-finite gradients still skip their tensor."""

    def init(self, device="cpu") -> ScalerState:
        return _state(1.0, device)

    def scale(self, loss, state):
        return loss

    @torch.no_grad()
    def unscale(self, grads, state, shards=None):
        finite = tree_finite_mask(grads, shards)
        skip_mask = tree_map(torch.logical_not, finite)
        grads = tree_map(lambda g, f: torch.where(f, g.float(), 0.0), grads, finite)
        return grads, skip_mask, state, {"n_skipped_tensors": _n_true(skip_mask),
                                         "loss_scale": state.scale}


def make_scaler(kind: str):
    if kind == "fixed_tensor":
        return FixedTensorLevelScaler()
    if kind == "dynamic":
        return DynamicLossScaler()
    if kind == "none":
        return NoOpScaler()
    raise ValueError(f"unknown scaler {kind!r}")
