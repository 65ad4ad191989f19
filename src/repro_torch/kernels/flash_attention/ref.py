"""Plain PyTorch versions of the flash-attention kernels.

The counterparts of the JAX package's ``repro/kernels/flash_attention/
ref.py`` (``mha_fwd``, ``decode_fwd``), in the model layout the wrappers
speak: q (B, Sq, H, hd), k/v (B, Sk, KV, hd), query head h reading KV head
``h // (H / KV)``. They materialise the full score matrix and take one
softmax over it, in f32, with one rounding to q's dtype at the end; the
kernels take an online softmax over key tiles, so the two agree to the
order of their sums, within the tolerances ``chip_smoke.py`` and the tests
state. q is scaled in f32 before the product, as the kernels (and the
TPU kernels) do.

``ops.py`` sends CPU tensors here; on the card ``chip_smoke.py`` holds each
CUDA kernel against these on the same inputs. Nothing on the card's main
path calls them.
"""
from __future__ import annotations

import numpy as np
import torch

# finite mask value, as the JAX kernels define it: -inf would NaN through
# exp(-inf - -inf) on a row whose running max is still the mask
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def _expand_heads(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd), each KV head repeated for its query
    group (``jnp.repeat`` order: 0,0,1,1, not 0,1,0,1)."""
    rep = n_heads // k.shape[2]
    return torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k


def _softmax_out(s: torch.Tensor, live: torch.Tensor, v: torch.Tensor):
    """Masked scores s (B, H, Sq, Sk) f32, ``live`` broadcasting against
    them, v (B, Sk, H, hd) f32 -> (o (B, Sq, H, hd) f32, lse (B, H, Sq)).
    Dead keys carry no weight; a row with no live key gives o = 0."""
    s = torch.where(live, s, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, v)
    return o, (m + torch.log(l_safe))[..., 0]


def mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, kv_valid: int, scale: float):
    """Returns (o (B, Sq, H, hd) in q's dtype, lse (B, H, Sq) f32). Keys at
    or past ``kv_valid`` are masked; with ``causal`` query i sees keys
    j <= i (positions from 0 on both sides)."""
    H = q.shape[2]
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale,
                     _expand_heads(k, H).float())
    kpos = torch.arange(Sk, device=q.device)[None, :]
    live = kpos < kv_valid
    if causal:
        live = live & (kpos <= torch.arange(Sq, device=q.device)[:, None])
    o, lse = _softmax_out(s, live, _expand_heads(v, H).float())
    return o.to(q.dtype), lse


def decode_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: torch.Tensor, *, scale: float) -> torch.Tensor:
    """q (B, 1, H, hd); k, v (B, S, KV, hd), the cache in its storage
    layout; kv_len (B,) int32 live cells per slot. Returns (B, 1, H, hd) in
    q's dtype. The JAX oracle takes a plain softmax over the masked row,
    which is the same for every kv_len >= 1; at kv_len == 0 this gives 0,
    as the kernels (which walk no tile then) do."""
    H, S = q.shape[2], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale,
                     _expand_heads(k, H).float())
    live = (torch.arange(S, device=q.device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    o, _ = _softmax_out(s, live, _expand_heads(v, H).float())
    return o.to(q.dtype)
