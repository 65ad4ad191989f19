"""Grouped-query attention with RoPE and the ring KV cache.

The PyTorch counterpart of ``repro/models/attention.py`` for the train
and serve paths. Two implementations, selected by ``attn_impl``:

* ``flash_scan`` (the default, as in the JAX package) — the flash-attention
  kernels of ``kernels/flash_attention``: the differentiable
  ``flash_attention`` (``flash_fwd``, and ``flash_bwd_dq``/``flash_bwd_dkv``
  under a gradient) for training and prefill, and ``decode_attention``
  for every decode step over the ring cache, GQA native (KV heads stay
  folded). On the card these are the CUDA kernels;
  on the CPU their plain versions. This is the branch the JAX package
  takes on its Pallas backends; its XLA-only ``flash_scan_attention``
  (a ``lax.scan`` for prompts past 2048) has no counterpart here, since
  the port has no XLA backend.
* ``dense`` — materialises the (B, H, Sq, Sk) scores in f32 after
  expanding the KV heads (the JAX package's oracle path, a plain product
  on the card as it is a plain product for XLA).

All projections route through ``quant_linear``, so SwitchBack applies to
Q/K/V/out.

Cache updates are in place: a ``KVCache`` holds views into the engine's
stacked cache tensors, and ``attention_decode_step`` /
``attention_prefill`` write new keys, values and lengths into them
(index writes; the JAX package returns new arrays instead).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.precision import QuantPolicy, quant_linear
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.models import params as PRM
from repro_torch.models.common import apply_rope, apply_rope_cached

NEG_INF = -2.0e38


class KVCache(NamedTuple):
    """Per-slot serve cache of one layer.

    ``length`` is (B,) int32: each batch slot's absolute token count.
    Writes land at ``length % S_max`` (a ring buffer: sequences longer
    than the cache keep the last ``S_max`` tokens) and attention masks each
    slot to its own valid prefix.
    """
    k: torch.Tensor          # (B, S_max, n_kv, hd)
    v: torch.Tensor          # (B, S_max, n_kv, hd)
    length: torch.Tensor     # (B,) int32


def qkv_project(x: torch.Tensor, p: dict, cfg, policy: QuantPolicy):
    """x: (B, S, D) -> q (B,S,H,hd), k,v (B,S,KV,hd)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cd = policy.compute_dtype
    wq = PRM.use_weight(p["wq"], ("embed", "heads"), cd)
    wk = PRM.use_weight(p["wk"], ("embed", "kv_heads"), cd)
    wv = PRM.use_weight(p["wv"], ("embed", "kv_heads"), cd)
    q = quant_linear(x, wq, policy=policy).reshape(B, S, H, hd)
    k = quant_linear(x, wk, policy=policy).reshape(B, S, KV, hd)
    v = quant_linear(x, wv, policy=policy).reshape(B, S, KV, hd)
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd), each KV head repeated for its
    query group (``jnp.repeat`` semantics: 0,0,1,1, not 0,1,0,1)."""
    rep = n_heads // k.shape[2]
    return torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention in f32. q: (B,Sq,H,hd); k,v: (B,Sk,H,hd);
    ``kv_len`` masks keys at or past it (broadcast against (B,H,Sq,Sk))."""
    Sq, hd = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    # 1 / sqrt(hd) rounded as the JAX package rounds it: both steps in f32
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal or kv_len is not None:
        kpos = torch.arange(Sk, device=q.device)[None, None, None, :]
        mask = torch.zeros((1, 1, 1, Sk), dtype=torch.bool, device=q.device)
        if causal:
            qpos = torch.arange(Sq, device=q.device)
            mask = mask | (kpos > qpos[None, None, :, None])
        if kv_len is not None:
            mask = mask | (kpos >= kv_len)
        s = s.masked_fill(mask, NEG_INF)
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", a, v.float())
    return out.to(q.dtype)


def _core_attention(q, k, v, *, causal: bool, impl: str = "flash_scan"):
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd) with KV heads folded. The JAX
    package's dispatch: anything but ``"dense"`` runs the flash kernel, which
    consumes GQA natively (and is differentiable through the backward
    kernels); ``"dense"`` expands KV heads for the oracle."""
    if impl != "dense":
        return FA.flash_attention(q, k, v, causal=causal)
    n_heads = q.shape[2]
    return dense_attention(q, _expand_kv(k, n_heads), _expand_kv(v, n_heads),
                           causal=causal)


def _out_proj(o: torch.Tensor, p: dict, cfg, policy: QuantPolicy):
    B, S = o.shape[:2]
    wo = PRM.use_weight(p["wo"], ("heads", "embed"), policy.compute_dtype)
    return quant_linear(o.reshape(B, S, cfg.n_heads * cfg.hd), wo, policy=policy)


def attention_block(x: torch.Tensor, p: dict, cfg, policy: QuantPolicy, *,
                    positions: torch.Tensor, causal: bool = True,
                    impl: str = "flash_scan") -> torch.Tensor:
    """Full self-attention sub-block with no cache, the training path:
    QKV projection -> RoPE -> attention -> output projection. x (B, S, D),
    positions (S,) or (B, S)."""
    q, k, v = qkv_project(x, p, cfg, policy)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = _core_attention(q, k, v, causal=causal, impl=impl)
    return _out_proj(o, p, cfg, policy)


def attention_decode_step(x: torch.Tensor, cache: KVCache, p: dict, cfg,
                          policy: QuantPolicy, *, rope_cache=None,
                          impl: str = "flash_scan") -> torch.Tensor:
    """One-token decode: x (B, 1, D); slot b holds ``cache.length[b]`` past
    tokens. Writes the new K/V at ``length % S_max`` in place, attends over
    ``min(length + 1, S_max)`` cells and advances every slot's length by
    one (in place). RoPE is applied at write time with the absolute
    position, so a wrapped cache needs no per-cell positions.
    ``rope_cache=(cos, sin)``: rows pre-gathered for this step's positions.
    Under ``flash_scan`` the re-attend is the decode kernel over the cache
    in its storage layout (a slot walks only its live tiles); ``dense``
    expands the whole cache and masks it. Returns the attention output
    (B, 1, D)."""
    B = x.shape[0]
    S_max = cache.k.shape[1]
    q, k, v = qkv_project(x, p, cfg, policy)
    if rope_cache is not None:
        q = apply_rope_cached(q, *rope_cache)
        k = apply_rope_cached(k, *rope_cache)
    else:
        pos = cache.length[:, None]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    rows = torch.arange(B, device=x.device)
    write_at = cache.length.long() % S_max                 # ring write position
    cache.k[rows, write_at] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, write_at] = v[:, 0].to(cache.v.dtype)
    valid = torch.clamp(cache.length + 1, max=S_max)       # (B,) int32
    if impl != "dense":
        o = FA.decode_attention(q, cache.k, cache.v, valid)
    else:
        o = dense_attention(q, _expand_kv(cache.k, cfg.n_heads),
                            _expand_kv(cache.v, cfg.n_heads), causal=False,
                            kv_len=valid[:, None, None, None])
    cache.length.add_(1)
    return _out_proj(o, p, cfg, policy)


def attention_prefill(x: torch.Tensor, cache: KVCache, p: dict, cfg,
                      policy: QuantPolicy, *, admit: torch.Tensor,
                      rope_cache=None, impl: str = "flash_scan") -> torch.Tensor:
    """Full-prompt causal attention that also seeds the serve cache.

    x: (B, S, D) prompts padded to S (S <= S_max); ``admit``: (B,) bool —
    slots being (re)filled. Admitted slots' cache rows [0, S) take the new
    K/V in place; the others keep theirs (the attention of every slot is
    computed, as in the JAX package). Lengths are set by the caller."""
    S = x.shape[1]
    q, k, v = qkv_project(x, p, cfg, policy)
    if rope_cache is not None:
        q = apply_rope_cached(q, *rope_cache)
        k = apply_rope_cached(k, *rope_cache)
    else:
        positions = torch.arange(S, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = _core_attention(q, k, v, causal=True, impl=impl)
    sel = admit[:, None, None, None]
    cache.k[:, :S] = torch.where(sel, k.to(cache.k.dtype), cache.k[:, :S])
    cache.v[:, :S] = torch.where(sel, v.to(cache.v.dtype), cache.v[:, :S])
    return _out_proj(o, p, cfg, policy)
