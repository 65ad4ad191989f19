"""Plain PyTorch versions of the paged-attention kernels.

The counterparts of the JAX package's ``repro/kernels/paged_attention/
ref.py``: each slot's logical blocks are gathered through the block table
into a dense (B, nb * bs, KV, hd) cache, and one masked softmax is taken
over it in f32, with one rounding to q's dtype at the end. The kernels
(``csrc/paged_attention.cu``) stream the same blocks with an online
softmax, so the two agree to the order of their sums, within the
tolerances ``chip_smoke.py`` and the tests state. q is scaled in f32
before the product, as the kernels (and the TPU kernels) do.

``ops.py`` sends CPU tensors here; on the card ``chip_smoke.py`` holds each
CUDA kernel against these on the same inputs. Nothing on the card's main
path calls them. ``split_bf16`` is the kernels' split of an f32 operand
into bf16 terms for the tensor cores, which the tests hold to its stated
width.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ref as _flash_ref


def gather_blocks(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(N+1, bs, KV, hd) pool + (B, nb) int32 table -> (B, nb * bs, KV, hd)
    dense cache in logical order (cell j * bs + o of slot b is the pool
    cell (tables[b, j], o)). Out-of-range ids clamp, as JAX's gather
    clamps them (a dead entry past a slot's live prefix may hold any id)."""
    B, nb = tables.shape
    idx = tables.long().clamp(0, pool.shape[0] - 1)
    g = pool[idx]                                    # (B, nb, bs, KV, hd)
    return g.reshape(B, nb * pool.shape[1], pool.shape[2], pool.shape[3])


def paged_decode_fwd(q, k_pool, v_pool, tables, kv_len, *, scale: float):
    """q (B, 1, H, hd); pools (N+1, bs, KV, hd); tables (B, nb) int32;
    kv_len (B,) int32 live cells per slot. Returns (B, 1, H, hd) in q's
    dtype: the gather-then-dense re-attend the decode kernel replaces. A
    slot with kv_len == 0 gives 0, as the kernel (which walks no block
    then) does."""
    k = gather_blocks(k_pool, tables)
    v = gather_blocks(v_pool, tables)
    return _flash_ref.decode_fwd(q, k, v, kv_len, scale=scale)


def paged_prefill_fwd(q, k_pool, v_pool, tables, q_off, kv_len, *,
                      scale: float):
    """Chunked-prefill attention with per-slot query offsets.

    q (B, Sq, H, hd), the model layout: row r of slot b at absolute
    position ``q_off[b] + r``; pools (N+1, bs, KV, hd) with the chunk's
    K/V already committed; tables (B, nb) int32; q_off, kv_len (B,) int32.
    Key j is live for row r iff ``j <= q_off[b] + r`` and ``j < kv_len[b]``.
    Returns (B, Sq, H, hd) in q's dtype; a row with no live key (a slot
    with kv_len == 0) gives exact zeros."""
    H = q.shape[2]
    k = _flash_ref._expand_heads(gather_blocks(k_pool, tables), H).float()
    v = _flash_ref._expand_heads(gather_blocks(v_pool, tables), H).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k)
    L, Sq = k.shape[1], q.shape[1]
    qpos = q_off.long()[:, None] + torch.arange(Sq, device=q.device)[None, :]
    kpos = torch.arange(L, device=q.device)[None, None, :]
    live = (kpos <= qpos[..., None]) & (kpos < kv_len.long()[:, None, None])
    o, _ = _flash_ref._softmax_out(s, live[:, None], v)
    return o.to(q.dtype)


def split_bf16(x: torch.Tensor, terms: int) -> list[torch.Tensor]:
    """x as ``terms`` bf16 tensors, largest first, each the nearest bf16 to
    what the earlier ones left (the f32 subtraction is exact): the kernels'
    operands for the tensor cores (``kernels/csrc/mma_tile.cuh``, shared
    with the flash kernels). q * scale takes 1 term (bf16 q, scale a power
    of two: exact) or 3, P (and the flash backward's dS) 3, an f32 pool's K
    and V 3. In the normal range 3 terms sum to x exactly and 2 to within
    2^-16 |x|."""
    out, r = [], x.float()
    for _ in range(terms):
        t = r.to(torch.bfloat16)
        out.append(t)
        r = r - t.float()
    return out
