"""AdaFactor (Shazeer & Stern 2018), the paper's point of comparison; the
port of ``repro/optim/adafactor.py``.

The paper's §3.5 / App. E discussion is anchored on it: StableAdamW ports
AdaFactor's update clipping onto AdamW and drops the pieces found to
underperform at scale (the factored second moment, no first moment,
relative step sizes; App. E.1).

This implementation, as the reference's: a factored second moment for
tensors with ndim >= 2 (row and column EMAs of g² over the last two axes,
on the stacked (L, n, m) leaves too, whose outer product over the row
mean rebuilds û), update clipping with d = ``clip_threshold`` (1), an
optional first moment (off by default, as in AdaFactor), decay
β̂₂ₜ = 1 − t^(−0.8). Every step is the reference's operation order in f32,
each division tensor by tensor (``div``).

One difference on purpose (ROADMAP.md Queue 3 #4): a tensor the skip mask
skips keeps its parameter and every tensor of its moment dict. The
reference's ``apply_skip_mask`` maps ``jnp.where`` over the per-leaf
moment dicts and raises, so no JAX train step can run AdaFactor; with no
tensor skipped the update is the reference's ``update(skip_mask=None)``.

Under the sharded engine (``shards``, a tree of LeafShard) each leaf is
this rank's slice: a row or column mean over the split dim, the mean of
``vr`` over its split last dim and the update's RMS sum their parts over
the ranks; ``state_logical_axes`` gives ``vr`` and ``vc`` the axes that
survive their reduction.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.quantization import div
from repro_torch.distributed import sharding as S
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim.base import Optimizer, Schedule, constant_schedule, default_wd_mask


class AdafactorState(NamedTuple):
    step: torch.Tensor       # 0-d int32
    moments: dict            # per leaf: {"vr", "vc"} (factored) or {"v"}, and "m"


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor(learning_rate: float | Schedule = 2e-3,
              decay_pow: float = 0.8,
              eps1: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.2,
              wd_mask_fn: Callable = default_wd_mask,
              beta1: float | None = None) -> Optimizer:
    sched = (learning_rate if callable(learning_rate)
             else constant_schedule(learning_rate))

    def init(params):
        def leaf(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                # the row EMA over the last dim, the column EMA over the one before
                m = {"vr": torch.zeros(p.shape[:-1], **f32),
                     "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            else:
                m = {"v": torch.zeros(p.shape, **f32)}
            if beta1 is not None:
                m["m"] = torch.zeros(p.shape, **f32)
            return m
        dev = tree_leaves(params)[0].device
        return AdafactorState(torch.zeros((), dtype=torch.int32, device=dev),
                              tree_map(leaf, params))

    @torch.no_grad()
    def update(params, state, grads, skip_mask=None, shards=None):
        t = state.step + 1
        tf = t.to(torch.float32)
        beta2t = 1.0 - tf ** (-decay_pow)
        lr = sched(state.step)
        wd_mask = wd_mask_fn(params)

        def leaf(p, g, mom, wm, skip, sh):
            gf = g.float()
            g2 = gf * gf + eps1
            new_mom = {}
            if _factored(p.shape):
                vr = beta2t * mom["vr"] + (1 - beta2t) * S.mean(g2, sh, dim=-1)
                vc = beta2t * mom["vc"] + (1 - beta2t) * S.mean(g2, sh, dim=-2)
                new_mom["vr"], new_mom["vc"] = vr, vc
                # û: vr ⊗ vc / mean(vr)
                denom = S.mean(vr, sh and sh.drop(-1), dim=-1, keepdim=True)
                u_hat = div(vr, torch.clamp_min(denom, eps1))[..., None] * vc[..., None, :]
            else:
                v = beta2t * mom["v"] + (1 - beta2t) * g2
                new_mom["v"] = v
                u_hat = v
            upd = div(gf, torch.sqrt(torch.clamp_min(u_hat, eps1)))
            # update clipping (d = clip_threshold): what StableAdamW ports
            rms_u = torch.sqrt(S.mean(upd * upd, sh))
            upd = div(upd, torch.clamp_min(div(rms_u, clip_threshold), 1.0))
            if beta1 is not None:
                m = beta1 * mom["m"] + (1 - beta1) * upd
                new_mom["m"] = m
                upd = m
            pf = p.float()
            # where(wm, pf, 0): an undecayed tensor would subtract an exact
            # zero, which changes no bit
            new_p = (pf - lr * weight_decay * pf - lr * upd if wm else pf - lr * upd).to(p.dtype)
            if skip is None:
                return new_p, new_mom
            # a skipped tensor keeps its parameter and its whole moment dict
            return (torch.where(skip, p, new_p),
                    {k: torch.where(skip, mom[k], v) for k, v in new_mom.items()})

        # the moments tree holds a dict at each parameter's place, which
        # tree_map hands over whole (it walks the first tree's dicts)
        skips = skip_mask if skip_mask is not None else tree_map(lambda p: None, params)
        shs = shards if shards is not None else tree_map(lambda p: None, params)
        out = tree_map(leaf, params, grads, state.moments, wd_mask, skips, shs)
        new_params = tree_map(lambda o: o[0], out)
        new_moments = tree_map(lambda o: o[1], out)
        return new_params, AdafactorState(t, new_moments), {"lr": lr}

    def state_logical_axes(param_specs):
        # factored moments are row/col means of g²: vr drops the last
        # logical axis, vc the second-to-last; each keeps the surviving
        # axes' sharding (1-D pspecs for 2-D params)
        def leaf(s):
            lg = tuple(s.logical)
            m = {"vr": lg[:-1], "vc": lg[:-2] + lg[-1:]} if _factored(s.shape) else {"v": lg}
            if beta1 is not None:
                m["m"] = lg
            return m
        return AdafactorState(step=(), moments=tree_map(leaf, param_specs))

    return Optimizer(init, update, state_logical_axes)
