"""Zero-init layer-scale (paper §2.3, Touvron et al. CaiT).

    x'  = x  + γ₁ * self_attention(norm₁(x))          (paper Eq. 5)
    x'' = x' + γ₂ * mlp(norm₂(x'))                    (paper Eq. 6)

The PyTorch counterpart of ``repro/core/layer_scale.py``.
"""
from __future__ import annotations

import torch


def apply_layer_scale(gamma: torch.Tensor | None,
                      branch_out: torch.Tensor) -> torch.Tensor:
    """γ * branch_output (broadcast over leading dims); identity if γ is
    None (layer-scale disabled)."""
    if gamma is None:
        return branch_out
    return branch_out * gamma.to(branch_out.dtype)
