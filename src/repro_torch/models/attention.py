"""Grouped-query attention with RoPE, the ring KV cache and the paged
(block-pool) KV cache.

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

Encoder-decoder cross attention (``encode_cross_kv``, ``cross_attention``):
the decoder's queries against the encoder output's keys and values, no
RoPE, no mask, through the same ``_core_attention`` (under ``flash_scan``
the flash kernels with Sq != Sk: the target length, or one row a decode
step, against the encoder's frames).

Paged serving (``PagedKVCache``) runs the block-table kernels of
``kernels/paged_attention`` under ``flash_scan`` (``paged_prefill_fwd`` for
prefill chunks and the speculative verify pass, ``paged_decode_fwd`` for
every decode step), and under ``dense`` the gather-then-dense oracle.

Cache updates are in place: a ``KVCache`` / ``PagedKVCache`` holds views
into the engine's stacked cache tensors, and the decode and prefill
functions write new keys, values and lengths into them (index writes; the
JAX package returns new arrays instead).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.precision import QuantPolicy, quant_linear
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.flash_attention.ref import MASK_VALUE
from repro_torch.kernels.paged_attention import ops as PA
from repro_torch.kernels.paged_attention import ref as PREF
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


# ---------------------------------------------------------------------------
# paged serving (block-pool KV cache)
# ---------------------------------------------------------------------------

class PagedKVCache(NamedTuple):
    """Block-pool KV cache of one layer.

    ``k``/``v`` are pools of physical blocks shared by every batch slot,
    (num_blocks + 1, block_size, n_kv, hd); the **last** block is the trash
    block that absorbs writes from idle slots and masked pad positions
    (writes there are never read). Which logical cell of which slot lives
    in which physical block is decided on the host
    (``serve/paged/block_pool.py``) and comes in as a (B, n_blocks_per_slot)
    int32 block table: cell ``j * bs + o`` of slot b is pool cell
    ``(tables[b, j], o)``. ``length`` is each slot's absolute token count.
    """
    k: torch.Tensor          # (num_blocks + 1, block_size, n_kv, hd)
    v: torch.Tensor
    length: torch.Tensor     # (B,) int32


def _paged_commit(buf: torch.Tensor, vals: torch.Tensor, phys: torch.Tensor,
                  off: torch.Tensor) -> None:
    """Write token K or V into pool cells, in place (the JAX package returns
    a new pool). buf (N+1, bs, KV, hd); vals (T, KV, hd); phys/off (T,).
    The caller routes masked writes to the trash block; duplicate targets
    only ever occur there."""
    buf[phys.long(), off.long()] = vals.to(buf.dtype)


def _paged_dense_prefill(q, k_suf, v_suf, cache: PagedKVCache, tables, pref_lens,
                         n_heads: int):
    """The ``dense`` oracle of a prefill chunk, the JAX package's on its XLA
    path op for op: the resident prefix gathered through the table in
    logical order, the suffix K/V (rounded through the cache dtype) after
    it, f32 scores, NEG_INF on dead columns (prefix cells at or past
    ``pref_lens``, suffix keys after the query), one softmax. Commit cells
    sit at or past ``pref_lens``, so gathering after the commit reads the
    same live prefix as before it."""
    B, S = q.shape[:2]
    nb, bs = tables.shape[1], cache.k.shape[1]
    k_suf = k_suf.to(cache.k.dtype).to(k_suf.dtype)
    v_suf = v_suf.to(cache.v.dtype).to(v_suf.dtype)
    kx = torch.cat([_expand_kv(PREF.gather_blocks(cache.k, tables), n_heads),
                    _expand_kv(k_suf, n_heads)], dim=1)
    vx = torch.cat([_expand_kv(PREF.gather_blocks(cache.v, tables), n_heads),
                    _expand_kv(v_suf, n_heads)], dim=1)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[3])))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kx.float())
    dead_pref = (torch.arange(nb * bs, device=q.device)[None, :]
                 >= pref_lens.long()[:, None])                       # (B, nb*bs)
    dead_suf = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    dead = torch.cat([dead_pref[:, None, None, :].expand(B, 1, S, nb * bs),
                      dead_suf[None, None].expand(B, 1, S, S)], dim=-1)
    a = torch.softmax(s.masked_fill(dead, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", a, vx.float()).to(q.dtype)


def _paged_dense_decode(q, cache: PagedKVCache, tables, kv_len, n_heads: int):
    """The ``dense`` oracle of a decode step, the JAX package's on its XLA
    path op for op: the gathered cache, f32 scores scaled after the
    product, MASK_VALUE on cells at or past ``kv_len``, one softmax."""
    kx = _expand_kv(PREF.gather_blocks(cache.k, tables), n_heads).float()
    vx = _expand_kv(PREF.gather_blocks(cache.v, tables), n_heads).float()
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[3])))
    s = scale * torch.einsum("bqhd,bkhd->bhqk", q.float(), kx)
    live = torch.arange(kx.shape[1], device=q.device)[None, :] < kv_len.long()[:, None]
    a = torch.softmax(s.masked_fill(~live[:, None, None, :], MASK_VALUE), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", a, vx).to(q.dtype)


def attention_paged_prefill(x: torch.Tensor, cache: PagedKVCache,
                            tables: torch.Tensor, p: dict, cfg,
                            policy: QuantPolicy, *, admit: torch.Tensor,
                            pref_lens: torch.Tensor, prompt_lens: torch.Tensor,
                            rope_cache=None, impl: str = "flash_scan") -> torch.Tensor:
    """Chunked prefill over a block table: run the prompt *suffix* whose K/V
    is not resident yet (not adopted from the prefix cache, not committed by
    an earlier chunk), attending to the resident blocks plus the suffix's
    own causal keys.

    x: (B, S, D) suffix tokens at positions ``pref_lens[b] + [0, S)``,
    right-padded; ``pref_lens`` (B,) resident prefix lengths (adopted full
    blocks, or the chunk cursor); ``prompt_lens`` (B,) prefill targets
    (cursor + chunk); ``admit`` (B,) bool. Commit-then-attend: the suffix
    K/V are written first into the slot's table blocks, in place
    (non-admitted and pad positions land in the trash block), and the
    attention sees them rounded through the cache dtype, as a later decode
    or a speculative verify pass re-scoring the same positions reads them.
    Under ``flash_scan`` the per-slot-offset prefill kernel streams prefix
    and suffix from the pools; under ``dense`` the oracle concatenates the
    gathered prefix and the rounded suffix. Lengths are set by the caller.
    Returns (B, S, D)."""
    B, S, _ = x.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    bs, nb = cache.k.shape[1], tables.shape[1]
    trash = cache.k.shape[0] - 1
    positions = pref_lens.long()[:, None] + torch.arange(S, device=x.device)[None, :]
    q, k, v = qkv_project(x, p, cfg, policy)
    if rope_cache is not None:
        q = apply_rope_cached(q, *rope_cache)
        k = apply_rope_cached(k, *rope_cache)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    # commit the suffix K/V at block granularity; masked positions -> trash
    valid = admit[:, None] & (positions < prompt_lens.long()[:, None])
    logical = torch.clamp(positions // bs, 0, nb - 1)
    phys = torch.where(valid, torch.gather(tables.long(), 1, logical), trash).reshape(-1)
    off = torch.where(valid, positions % bs, 0).reshape(-1)
    _paged_commit(cache.k, k.reshape(B * S, KV, hd), phys, off)
    _paged_commit(cache.v, v.reshape(B * S, KV, hd), phys, off)

    kv_valid = torch.where(admit, prompt_lens, 0).to(torch.int32)
    if impl != "dense":
        o = PA.paged_prefill_attention(q.contiguous(), cache.k, cache.v, tables,
                                       pref_lens.to(torch.int32), kv_valid)
    else:
        o = _paged_dense_prefill(q, k, v, cache, tables, pref_lens, cfg.n_heads)
    return _out_proj(o, p, cfg, policy)


def attention_paged_decode_step(x: torch.Tensor, cache: PagedKVCache,
                                tables: torch.Tensor, p: dict, cfg,
                                policy: QuantPolicy, *, rope_cache=None,
                                impl: str = "flash_scan") -> torch.Tensor:
    """One-token decode through the block table: slot b's new K/V land in
    pool cell ``(tables[b, length[b] // bs], length[b] % bs)`` in place (the
    engine guarantees the block exists for live slots; idle slots' rows
    point at the trash block), then the re-attend over the slot's
    ``min(length + 1, nb * bs)`` cells: the paged decode kernel under
    ``flash_scan``, the gather-then-dense oracle under ``dense``. Every
    slot's length advances by one (in place), as in the ring path. Returns
    the attention output (B, 1, D)."""
    bs, nb = cache.k.shape[1], tables.shape[1]
    q, k, v = qkv_project(x, p, cfg, policy)
    if rope_cache is not None:
        q = apply_rope_cached(q, *rope_cache)
        k = apply_rope_cached(k, *rope_cache)
    else:
        pos = cache.length[:, None]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    length = cache.length.long()
    logical = torch.clamp(length // bs, 0, nb - 1)
    phys = torch.gather(tables.long(), 1, logical[:, None])[:, 0]
    off = length % bs
    _paged_commit(cache.k, k[:, 0], phys, off)
    _paged_commit(cache.v, v[:, 0], phys, off)
    valid = torch.clamp(cache.length + 1, max=nb * bs).to(torch.int32)   # (B,)
    if impl != "dense":
        o = PA.paged_decode_attention(q.contiguous(), cache.k, cache.v, tables, valid)
    else:
        o = _paged_dense_decode(q, cache, tables, valid, cfg.n_heads)
    cache.length.add_(1)
    return _out_proj(o, p, cfg, policy)


# ---------------------------------------------------------------------------
# encoder-decoder cross attention
# ---------------------------------------------------------------------------

def cross_attention(x: torch.Tensor, enc_kv, p: dict, cfg, policy: QuantPolicy, *,
                    impl: str = "flash_scan") -> torch.Tensor:
    """Encoder-decoder cross attention: x (B, S, D) the decoder's states,
    ``enc_kv`` the encoder's (k, v), each (B, Se, KV, hd), from
    ``encode_cross_kv``. Non-causal, no RoPE; returns (B, S, D)."""
    B, S, _ = x.shape
    wq = PRM.use_weight(p["wq"], ("embed", "heads"), policy.compute_dtype)
    q = quant_linear(x, wq, policy=policy).reshape(B, S, cfg.n_heads, cfg.hd)
    k, v = enc_kv
    o = _core_attention(q, k, v, causal=False, impl=impl)
    return _out_proj(o, p, cfg, policy)


def encode_cross_kv(enc_out: torch.Tensor, p: dict, cfg, policy: QuantPolicy):
    """The cross attention's keys and values from the encoder output
    (B, Se, D): (k, v), each (B, Se, KV, hd)."""
    B, Se, _ = enc_out.shape
    cd = policy.compute_dtype
    wk = PRM.use_weight(p["wk"], ("embed", "kv_heads"), cd)
    wv = PRM.use_weight(p["wv"], ("embed", "kv_heads"), cd)
    k = quant_linear(enc_out, wk, policy=policy).reshape(B, Se, cfg.n_kv_heads, cfg.hd)
    v = quant_linear(enc_out, wv, policy=policy).reshape(B, Se, cfg.n_kv_heads, cfg.hd)
    return k, v
