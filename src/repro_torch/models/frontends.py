"""Stub modality frontends: the multimodal [vlm] and [audio] entries are
transformer backbones, and the frontend hands them precomputed
embeddings.

The PyTorch counterpart of ``repro/models/frontends.py``.
``frontend_embed_shape`` is the (batch, patches or frames, d_model) shape
the stub delivers; ``synthetic_frontend_batch`` draws random features for
the CLIs and the tests. The JAX package draws them with
``jax.random.normal`` (threefry, which torch cannot replay); here they come
from a seeded ``numpy.random.Generator``, so a seed gives the same
features on every device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def frontend_embed_shape(cfg: ModelConfig, batch: int):
    """(B, n_frontend_tokens, d_model) precomputed patch/frame embeddings."""
    assert cfg.frontend in ("vision_stub", "audio_stub")
    return (batch, cfg.frontend_tokens, cfg.d_model)


def synthetic_frontend_batch(generator: np.random.Generator, cfg: ModelConfig, batch: int,
                             dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    """Standard normal features of ``frontend_embed_shape``, drawn in f32
    from ``generator`` and cast to ``dtype`` on ``device``."""
    x = generator.standard_normal(frontend_embed_shape(cfg, batch), dtype=np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)
