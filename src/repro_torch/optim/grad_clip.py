"""Global-norm gradient clipping (``repro/optim/grad_clip.py``): the
stability intervention the paper compares StableAdamW against (Fig. 10).
Clip norm 1.0 is the paper's footnote-4 setting."""
from __future__ import annotations

import torch

from repro_torch.core.quantization import div
from repro_torch.models.params import tree_map
from repro_torch.optim.base import global_norm


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float = 1.0, shards=None):
    """Returns (clipped_grads, pre_clip_norm); the norm over whole tensors
    where ``shards`` splits them (``optim/base.global_norm``)."""
    norm = global_norm(grads, shards)
    scale = torch.clamp_max(div(max_norm, torch.clamp_min(norm, 1e-12)), 1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm
