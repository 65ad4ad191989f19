"""Single dispatch point: config -> (param_specs, loss function).

The PyTorch counterpart of ``repro/models/model_zoo.py``. Families:

* LM (dense, mixture of experts, SSM, hybrid, vision-language):
  ``models/transformer.py``
* enc-dec (seamless-m4t-large-v2): ``models/encdec.py``
* CLIP (the paper's own model): ``models/clip.py``
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from repro_torch.configs.base import CLIPConfig
from repro_torch.models import clip as CL
from repro_torch.models import encdec as ED
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
    if cfg.family == "encdec" or cfg.encdec is not None:
        return ModelBundle(
            cfg=cfg, param_specs=ED.param_specs(cfg),
            loss_fn=lambda p, b, pol, par, **kw: ED.loss_fn(p, b, cfg, pol, par))
    return ModelBundle(
        cfg=cfg, param_specs=TF.param_specs(cfg),
        loss_fn=lambda p, b, pol, par, **kw: TF.loss_fn(p, b, cfg, pol, par))
