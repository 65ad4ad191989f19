"""Optimizers and stabilization (paper §3): the port of ``repro/optim``.
AdaFactor is not ported yet (ROADMAP.md Queue 1) and raises."""
from repro_torch.optim.base import Optimizer, default_wd_mask, global_norm  # noqa: F401
from repro_torch.optim.grad_clip import clip_by_global_norm  # noqa: F401
from repro_torch.optim.loss_scaler import (  # noqa: F401
    DynamicLossScaler, FixedTensorLevelScaler, NoOpScaler, make_scaler)
from repro_torch.optim.schedules import beta2_warmup, warmup_constant, warmup_cosine  # noqa: F401
from repro_torch.optim.stable_adamw import adamw, stable_adamw  # noqa: F401


def make_optimizer(name: str, learning_rate, **kw) -> Optimizer:
    if name == "stable_adamw":
        return stable_adamw(learning_rate, **kw)
    if name == "adamw":
        return adamw(learning_rate, **kw)
    if name == "adafactor":
        raise NotImplementedError(
            "optimizer 'adafactor' is not ported yet (ROADMAP.md Queue 1); "
            "the port runs stable_adamw and adamw")
    raise ValueError(f"unknown optimizer {name!r}")
