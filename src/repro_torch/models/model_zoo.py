"""Single dispatch point: config -> (param_specs, loss function).

The PyTorch counterpart of ``repro/models/model_zoo.py`` for the dense
family; CLIP, enc-dec, MoE and SSM families join with their own slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

from repro_torch.models import transformer as TF


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """What the trainer and the serve engine need for one architecture."""
    cfg: Any
    param_specs: Dict
    loss_fn: Callable            # (params, batch, policy, parallel) -> (loss, metrics)


def build(cfg) -> ModelBundle:
    TF.require_dense(cfg, "model_zoo.build")
    return ModelBundle(
        cfg=cfg, param_specs=TF.param_specs(cfg),
        loss_fn=lambda p, b, pol, par, **kw: TF.loss_fn(p, b, cfg, pol, par))
