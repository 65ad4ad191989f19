"""Single dispatch point: config -> (param_specs, serving functions).

The PyTorch counterpart of ``repro/models/model_zoo.py`` for the dense
family. Training (``loss_fn``/``forward_fn``) joins with the training
slice; CLIP, enc-dec, MoE and SSM families with their own slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.models import transformer as TF


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """What the serve engine needs for one architecture."""
    cfg: Any
    param_specs: Dict


def build(cfg) -> ModelBundle:
    TF.require_dense(cfg, "model_zoo.build")
    return ModelBundle(cfg=cfg, param_specs=TF.param_specs(cfg))
