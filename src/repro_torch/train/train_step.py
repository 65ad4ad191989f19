"""The training step: loss -> (scaled) grads -> clip -> optimizer.

The port of ``repro/train/train_step.py``:

* microbatch gradient accumulation (a loop over ``microbatch_steps``
  slices of the batch; activation memory / n_micro);
* loss scaling (the paper's §3.6 tensor-level fixed scaler, or the dynamic
  baseline);
* global-norm clipping (the paper's comparison intervention, Fig. 10);
* StableAdamW / AdamW through the Optimizer protocol;
* per-tensor RMS_t and the int8 quant-health scalars in the metrics, with
  the JAX package's keys;
* patch dropout (CLIP): the state carries a ``torch.Generator`` where the
  JAX state carries a PRNG key; each loss call draws its kept-patch
  indices from it (``bundle.patch_keep``) where the JAX step splits the
  key and hands ``patch_drop_rng`` to the loss.

The gradient comes from ``torch.autograd.grad`` through leaves that share
the master weights' storage; the optimizer then returns new tensors under
``torch.no_grad()``. Every metric stays a device tensor: the step never
waits for the card, the trainer fetches them at its flush points.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.core.quantization import div
from repro_torch.models.transformer import require_no_remat
from repro_torch.optim import (clip_by_global_norm, global_norm, make_optimizer,
                               make_scaler, warmup_cosine)
from repro_torch.models.params import tree_leaves, tree_map, tree_paths, tree_unflatten
from repro_torch.telemetry import health


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    scaler_state: Any
    step: torch.Tensor           # 0-d int32 on the parameters' device
    rng: torch.Generator         # on the parameters' device; patch dropout


def make_train_setup(train_cfg: TrainConfig):
    """(optimizer, loss scaler) of a TrainConfig: warmup-cosine lr."""
    sched = warmup_cosine(train_cfg.learning_rate, train_cfg.warmup_steps,
                          train_cfg.total_steps)
    if train_cfg.optimizer == "adafactor":
        opt = make_optimizer("adafactor", sched, weight_decay=train_cfg.weight_decay)
    else:
        opt = make_optimizer(train_cfg.optimizer, sched, beta1=train_cfg.beta1,
                             beta2=train_cfg.beta2,
                             weight_decay=train_cfg.weight_decay)
    return opt, make_scaler(train_cfg.loss_scaler)


def init_train_state(params, opt, scaler, seed: int = 0) -> TrainState:
    """The JAX state, with a ``torch.Generator`` seeded by ``seed`` in
    place of ``PRNGKey(seed)``."""
    dev = tree_leaves(params)[0].device
    return TrainState(params, opt.init(params), scaler.init(dev),
                      torch.zeros((), dtype=torch.int32, device=dev),
                      torch.Generator(device=dev).manual_seed(seed))


def _split_microbatches(batch: Dict, n: int) -> list:
    """n slices of every batch entry along its first dim (the JAX
    ``reshape((n, B // n) + ...)``: slice i holds rows [i B/n, (i+1) B/n))."""
    parts = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:])) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def loss_and_grads(bundle, policy: QuantPolicy, parallel: ParallelConfig, params,
                   batch: Dict, scale: Callable = lambda loss: loss, **loss_kw):
    """(gradient tree of ``scale(loss)``, loss, metrics) for one batch, by
    autograd through leaves that share the parameters' storage; the
    gradients of f32 master weights are f32. ``loss_kw`` goes to the
    bundle's loss (``patch_keep`` for CLIP)."""
    paths = [p for p, _ in tree_paths(params)]
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = bundle.loss_fn(tree_unflatten(params, dict(zip(paths, leaves))),
                                       batch, policy, parallel, **loss_kw)
        grads = torch.autograd.grad(scale(loss), leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (tree_unflatten(params, dict(zip(paths, grads))), loss.detach(),
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(bundle, policy: QuantPolicy, parallel: ParallelConfig,
                    train_cfg: TrainConfig, opt, scaler) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics)."""
    require_no_remat(parallel)
    if parallel.attn_block_q or parallel.attn_block_k:
        raise NotImplementedError(
            "attn_block_q/attn_block_k are the TPU kernels' tile sizes; the card's "
            "kernels choose their own tiles (leave them 0)")
    n_micro = max(1, train_cfg.microbatch_steps)

    def grads_of(state, mb):
        kw = {} if bundle.patch_keep is None else {"patch_keep": bundle.patch_keep(state.rng)}
        return loss_and_grads(bundle, policy, parallel, state.params, mb,
                              scale=lambda loss: scaler.scale(loss, state.scaler_state), **kw)

    @torch.no_grad()
    def train_step(state: TrainState, batch: Dict):
        if n_micro == 1:
            grads, loss, metrics = grads_of(state, batch)
        else:
            g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), state.params)
            l_acc = torch.zeros((), dtype=torch.float32, device=state.step.device)
            mb_metrics = []
            for mb in _split_microbatches(batch, n_micro):
                g, l, m = grads_of(state, mb)
                g_acc = tree_map(torch.add, g_acc, g)
                l_acc = l_acc + l
                mb_metrics.append(m)
            grads = tree_map(lambda g: div(g, float(n_micro)), g_acc)
            loss = div(l_acc, float(n_micro))
            # the keys of n_micro = 1: float metrics averaged over the
            # microbatches, integral ones the last value
            metrics = {k: (torch.mean(torch.stack([m[k] for m in mb_metrics]), dim=0)
                           if mb_metrics[-1][k].is_floating_point() else mb_metrics[-1][k])
                       for k in mb_metrics[-1]}

        grads, skip_mask, scaler_state, sstats = scaler.unscale(grads, state.scaler_state)
        gnorm = global_norm(grads)
        if train_cfg.grad_clip_norm > 0:
            grads, _ = clip_by_global_norm(grads, train_cfg.grad_clip_norm)

        params, opt_state, aux = opt.update(state.params, state.opt_state, grads,
                                            skip_mask=skip_mask)
        out = {**metrics, "loss": loss, "grad_norm": gnorm,
               "lr": aux.get("lr", torch.zeros(())),
               "n_skipped_tensors": sstats["n_skipped_tensors"],
               "loss_scale": sstats["loss_scale"]}
        out.update(health.quant_health(state.params, grads, train_cfg))
        if "rms" in aux:                       # per-tensor RMS_t (Fig. 9)
            out["rms"] = aux["rms"]
        return TrainState(params, opt_state, scaler_state, state.step + 1, state.rng), out

    return train_step
