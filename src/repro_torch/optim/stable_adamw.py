"""StableAdamW: AdamW with AdaFactor update clipping (paper Algorithm 2);
the port of ``repro/optim/stable_adamw.py``.

Per tensor, RMS_t = sqrt(mean(g² / max(u_t, ε²))) and the learning rate is
divided by max(1, RMS_t), so a stale second moment (the paper's
"stuck-in-the-past" failure, §3.4) cannot blow up the step. β̂ debiasing
is applied to the betas (AdaFactor §7.1 form), ε inside the max is
squared, and weight decay takes the clipped η_t.

Numerics follow the JAX function op by op in f32: β̂ is computed from the
step in f32 tensors (a Python float power would round differently, the
trap of two roundings), every division is tensor by tensor, and ε² stays
inside the max.

Under the sharded engine each leaf is this rank's slice (``shards``, a
tree of LeafShard): the moments are elementwise and stay local, RMS_t is a
mean over the whole tensor (its split leaves' sums all-reduced), and
``state_logical_axes`` gives the moments their parameter's axes.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.quantization import div
from repro_torch.distributed import sharding as S
from repro_torch.models.params import tree_from_leaves, tree_leaves, tree_map
from repro_torch.optim.base import (Optimizer, Schedule, apply_skip_mask,
                                    constant_schedule, default_wd_mask,
                                    param_logical_axes, shard_leaves)


class StableAdamWState(NamedTuple):
    step: torch.Tensor       # 0-d int32
    exp_avg: dict            # v_t (first moment), f32
    exp_avg_sq: dict         # u_t (second moment), f32


def _beta_hat(beta: float, tf: torch.Tensor) -> torch.Tensor:
    """β · (1 − β^(t−1)) / (1 − β^t), all in f32 tensors."""
    b = torch.full_like(tf, beta)
    return div(b * (1.0 - b ** (tf - 1.0)), 1.0 - b ** tf)


def stable_adamw(learning_rate: float | Schedule = 2e-3,
                 beta1: float = 0.9,
                 beta2: float = 0.95,
                 eps: float = 1e-6,
                 weight_decay: float = 0.2,
                 wd_mask_fn: Callable = default_wd_mask,
                 clipping: bool = True) -> Optimizer:
    """Algorithm 2. ``clipping=False`` is plain AdamW with the same β̂
    debiasing (the paper's unstable baseline)."""
    sched = (learning_rate if callable(learning_rate)
             else constant_schedule(learning_rate))

    def init(params):
        zeros = lambda: tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        dev = tree_leaves(params)[0].device
        return StableAdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                                zeros(), zeros())

    @torch.no_grad()
    def update(params, state, grads, skip_mask=None, shards=None):
        t = state.step + 1
        tf = t.to(torch.float32)
        b1t, b2t = _beta_hat(beta1, tf), _beta_hat(beta2, tf)

        gf = tree_map(lambda g: g.float(), grads)
        v = tree_map(lambda m, g: b1t * m + (1.0 - b1t) * g, state.exp_avg, gf)
        u = tree_map(lambda s, g: b2t * s + (1.0 - b2t) * g * g, state.exp_avg_sq, gf)
        # per-tensor RMS_t = sqrt(mean(g² / max(u, ε²))), the spike signal
        ratio = tree_map(lambda g, uu: div(g * g, torch.clamp_min(uu, eps * eps)), gf, u)
        rms = tree_from_leaves(ratio, [torch.sqrt(m) for m in S.tree_mean(
            tree_leaves(ratio), shard_leaves(ratio, shards))])

        lr = sched(state.step)
        wd_mask = wd_mask_fn(params)

        def step_fn(p, vv, uu, r, wm):
            eta = div(lr, torch.clamp_min(r, 1.0)) if clipping else lr
            upd = div(vv, torch.sqrt(uu) + eps)
            pf = p.float()
            # where(wm, pf, 0): a decayed tensor subtracts eta·wd·pf; the
            # others subtract an exact zero, which changes no bit
            new = pf - eta * weight_decay * pf - eta * upd if wm else pf - eta * upd
            return new.to(p.dtype)

        new_params = tree_map(step_fn, params, v, u, rms, wd_mask)
        # §3.6 tensor-level skip: a skipped tensor keeps params and moments
        new_params = apply_skip_mask(skip_mask, new_params, params)
        v = apply_skip_mask(skip_mask, v, state.exp_avg)
        u = apply_skip_mask(skip_mask, u, state.exp_avg_sq)
        return new_params, StableAdamWState(t, v, u), {"rms": rms, "lr": lr}

    def state_logical_axes(param_specs):
        # moments are elementwise EMAs: they shard exactly like their param
        axes = param_logical_axes(param_specs)
        return StableAdamWState(step=(), exp_avg=axes, exp_avg_sq=axes)

    return Optimizer(init, update, state_logical_axes)


def adamw(learning_rate=2e-3, beta1=0.9, beta2=0.999, eps=1e-8,
          weight_decay=0.2, wd_mask_fn=default_wd_mask) -> Optimizer:
    """Plain AdamW (β2 = 0.999), the paper's unstable baseline: the
    StableAdamW code path with clipping off."""
    return stable_adamw(learning_rate, beta1, beta2, eps, weight_decay,
                        wd_mask_fn, clipping=False)
