"""Shared model components: norms, RoPE, activations, embeddings.

The PyTorch counterpart of ``repro/models/common.py``: same operations in
the same order and dtypes (f32 inside norms, RoPE and the SwiGLU gate).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gain.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, gain: torch.Tensor,
               bias: torch.Tensor | None = None, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * gain.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def apply_norm(x: torch.Tensor, p: dict, kind: str, eps: float) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"], eps)
    return layer_norm(x, p["scale"], p.get("bias"), eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)    # (hd/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs          # (B, S, hd/2)
    return _rotate(x, torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :])


def rope_tables(head_dim: int, theta: float, max_pos: int, device="cpu"):
    """Precomputed (cos, sin) tables, each (max_pos, head_dim/2) f32. Row
    ``p`` holds the values ``apply_rope`` computes for position ``p`` (the
    same f32 multiply, then cos/sin), so gathering rows and applying
    :func:`apply_rope_cached` equals the on-the-fly path bit for bit."""
    ang = (torch.arange(max_pos, dtype=torch.float32, device=device)[:, None]
           * rope_freqs(head_dim, theta, device))
    return torch.cos(ang), torch.sin(ang)


def apply_rope_cached(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd/2) or (B, S, hd/2) gathered rows of
    :func:`rope_tables`. Same rotation (and op order) as apply_rope."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def activation(h: torch.Tensor, gate: torch.Tensor | None, act: str) -> torch.Tensor:
    if act == "swiglu":
        assert gate is not None
        return F.silu(gate.float()).to(h.dtype) * h
    if act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(h.float(), approximate="tanh").to(h.dtype)
    raise ValueError(act)


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Gather rows, then cast: the JAX package casts the whole table first,
    but an elementwise cast commutes with a gather, so the values are the
    same and only the gathered rows are converted."""
    return emb[tokens].to(dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       softcap: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy with an f32 log-softmax (stable under bf16
    logits), as ``repro/models/common.py`` computes it."""
    lf = logits.float()
    if softcap:
        lf = softcap * torch.tanh(lf / softcap)
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - picked)
