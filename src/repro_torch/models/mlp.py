"""Transformer MLP (SwiGLU / GELU) through the precision policy; the
PyTorch counterpart of ``repro/models/mlp.py``."""
from __future__ import annotations

import torch

from repro_torch.core.precision import QuantPolicy, quant_linear
from repro_torch.models import params as PRM
from repro_torch.models.common import activation


def mlp_block(x: torch.Tensor, p: dict, cfg, policy: QuantPolicy) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D). SwiGLU uses w_gate; GELU does not."""
    cd = policy.compute_dtype
    h = quant_linear(x, PRM.use_weight(p["w_up"], ("embed", "mlp"), cd),
                     policy=policy)
    g = (quant_linear(x, PRM.use_weight(p["w_gate"], ("embed", "mlp"), cd),
                      policy=policy) if "w_gate" in p else None)
    h = activation(h, g, cfg.act)
    return quant_linear(h, PRM.use_weight(p["w_down"], ("mlp", "embed"), cd),
                        policy=policy)
