"""Single dispatch point: config -> (param_specs, loss function).

The PyTorch counterpart of ``repro/models/model_zoo.py`` for the dense
decoder family and CLIP (the paper's own model); enc-dec, MoE and SSM
families join with their own slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from repro_torch.configs.base import CLIPConfig
from repro_torch.models import clip as CL
from repro_torch.models import transformer as TF


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """What the trainer and the serve engine need for one architecture.

    ``patch_keep``: ``draw(torch.Generator) -> kept patch indices`` for
    one loss call, for a model with patch dropout (CLIP), else None. The
    train step draws from the generator its state carries and hands the
    indices to ``loss_fn(..., patch_keep=...)``, where the JAX step hands
    a PRNG key (``patch_drop_rng``)."""
    cfg: Any
    param_specs: Dict
    loss_fn: Callable            # (params, batch, policy, parallel, **kw) -> (loss, metrics)
    patch_keep: Optional[Callable] = None


def build(cfg) -> ModelBundle:
    if isinstance(cfg, CLIPConfig):
        return ModelBundle(
            cfg=cfg, param_specs=CL.param_specs(cfg),
            loss_fn=lambda p, b, pol, par, **kw: CL.clip_loss(p, b, cfg, pol, par, **kw),
            patch_keep=CL.patch_keep_sampler(cfg))
    TF.require_dense(cfg, "model_zoo.build")
    return ModelBundle(
        cfg=cfg, param_specs=TF.param_specs(cfg),
        loss_fn=lambda p, b, pol, par, **kw: TF.loss_fn(p, b, cfg, pol, par))
