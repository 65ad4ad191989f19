"""Feature-magnitude tracking (paper Figure 5-right / Figure 14); the port
of ``repro/stability/feature_stats.py``.

The paper measures E[|x_k|], the mean absolute activation of each
transformer block's output, to show that without zero-init layer-scale the
magnitude grows with depth, which breaks tensor-wise fp8. The ViT blocks
return it per block when asked (``collect_stats``).
"""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_map


def block_feature_magnitude(x: torch.Tensor) -> torch.Tensor:
    """E[|x_k|] of one block's output, an f32 scalar."""
    return torch.mean(torch.abs(x.float()))


def gradient_stats(grads) -> dict:
    """mean and max |g| per tensor (paper Fig. 14 left) and its count of
    Inf/NaN values."""
    def leaf(g):
        gf = torch.abs(g.float())
        return {"mean": torch.mean(gf), "max": torch.max(gf),
                "nonfinite": torch.sum(~torch.isfinite(g.float()))}
    return tree_map(leaf, grads)
