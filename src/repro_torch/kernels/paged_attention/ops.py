"""Public wrappers for the paged-attention kernels: dispatch by device.

Model layout, as the JAX package's ``repro/kernels/paged_attention/ops.py``
speaks it: decode q (B, 1, H, hd), prefill q (B, S, H, hd); k_pool/v_pool
(N+1, block_size, KV, hd), the physical block pools (block N is the
engine's trash block); tables (B, n_blocks_per_slot) int32 logical ->
physical block ids; kv_len (B,) int32 live cells per slot; prefill also
takes q_off (B,) int32, the absolute position of each slot's query row 0.
H is a multiple of KV (query head h reads KV head ``h // (H/KV)``);
outputs match q.

A tensor on the CPU goes to the plain version in ``ref.py``. A tensor on
the card goes to the hand-written CUDA kernel (``csrc/paged_attention.cu``),
or the wrapper raises: there is no switch that sends a CUDA tensor to the
plain version, and no fallback when the build or a launch fails. The
kernels read the model layout and the pools through their own offsets, so
nothing is transposed, gathered or padded.

Each wrapper counts its kernel's launches in a plain int attribute
(``paged_decode_attention.launches`` ...), incremented only where it
launches; ``launch_counts`` (keyed by kernel name) and
``reset_launch_counts`` read and zero them all.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.flash_attention.ops import softmax_scale
from repro_torch.kernels.paged_attention import ref as _ref

_FLOAT_TYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128       # the kernels pad hd to 64 or 128 for their mma tiles
MAX_BLOCK_SIZE = 64      # whole blocks are staged in shared memory


def _lib():
    from repro_torch.kernels.paged_attention.build import load
    return load()


def _check(q, k_pool, v_pool, tables, lens):
    _b.need(q, "q", _FLOAT_TYPES, 4)
    _b.need(k_pool, "k_pool", _FLOAT_TYPES, 4)
    _b.need(v_pool, "v_pool", _FLOAT_TYPES, 4)
    _b.need(tables, "tables", (torch.int32,), 2)
    if k_pool.dtype != v_pool.dtype or k_pool.shape != v_pool.shape:
        raise ValueError(f"k_pool {tuple(k_pool.shape)} {k_pool.dtype} and v_pool "
                         f"{tuple(v_pool.shape)} {v_pool.dtype} differ")
    B, _, H, hd = q.shape
    _, bs, KV, phd = k_pool.shape
    if phd != hd or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not match pools {tuple(k_pool.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} not in [1, {MAX_HEAD_DIM}]")
    if not 1 <= bs <= MAX_BLOCK_SIZE:
        raise ValueError(f"block size {bs} not in [1, {MAX_BLOCK_SIZE}]")
    if tables.shape[0] != B:
        raise ValueError(f"tables {tuple(tables.shape)} for {B} slots")
    for t, name in lens:
        _b.need(t, name, (torch.int32,), 1)
        if t.shape[0] != B:
            raise ValueError(f"{name} {tuple(t.shape)} != ({B},)")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           tables: torch.Tensor, kv_len: torch.Tensor) -> torch.Tensor:
    """Single-query attention over the paged KV cache: q (B, 1, H, hd),
    pools (N+1, bs, KV, hd), tables (B, nb), kv_len (B,) -> (B, 1, H, hd).
    q and the pools may differ in dtype (f32 compute over a bf16 cache).
    A slot walks only the blocks below ``cdiv(kv_len, bs)`` and reads no
    table entry past them; kv_len == 0 gives 0."""
    _check(q, k_pool, v_pool, tables, ((kv_len, "kv_len"),))
    B, one, H, hd = q.shape
    if one != 1:
        raise ValueError(f"decode takes one query per slot, got q {tuple(q.shape)}")
    scale = softmax_scale(hd)
    if _b.on_cpu(q, k_pool, v_pool, tables, kv_len):
        return _ref.paged_decode_fwd(q, k_pool, v_pool, tables, kv_len, scale=scale)
    o = torch.empty_like(q)
    _b.launch(_lib().pa_paged_decode_fwd, q.data_ptr(), k_pool.data_ptr(),
              v_pool.data_ptr(), tables.data_ptr(), kv_len.data_ptr(), o.data_ptr(),
              int(q.dtype == torch.bfloat16), int(k_pool.dtype == torch.bfloat16),
              B, H, k_pool.shape[2], hd, k_pool.shape[0], k_pool.shape[1], tables.shape[1],
              scale, _b.stream(q))
    paged_decode_attention.launches += 1
    return o


def paged_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                            tables: torch.Tensor, q_off: torch.Tensor,
                            kv_len: torch.Tensor) -> torch.Tensor:
    """Chunked-prefill attention over the paged KV cache, the chunk's own
    K/V already committed to the pools (commit-then-attend): q (B, S, H,
    hd), row r of slot b at absolute position ``q_off[b] + r``; key j is
    live iff ``j <= q_off[b] + r`` and ``j < kv_len[b]``. Returns (B, S,
    H, hd); a slot with kv_len == 0 gives exact zeros.

    Besides chunked prefill this is the speculative verify pass (S =
    spec_k + 1, q_off the slot's resident length). On the card row r at
    position p runs the same operations in the same order as
    :func:`paged_decode_attention` at ``kv_len = p + 1`` (the same
    tensor-core template, a 16-row tile a warp), so the verify pass and a
    recomputed prefill give a plain decode's bits."""
    _check(q, k_pool, v_pool, tables, ((q_off, "q_off"), (kv_len, "kv_len")))
    B, S, H, hd = q.shape
    scale = softmax_scale(hd)
    if _b.on_cpu(q, k_pool, v_pool, tables, q_off, kv_len):
        return _ref.paged_prefill_fwd(q, k_pool, v_pool, tables, q_off, kv_len,
                                      scale=scale)
    o = torch.empty_like(q)
    _b.launch(_lib().pa_paged_prefill_fwd, q.data_ptr(), k_pool.data_ptr(),
              v_pool.data_ptr(), tables.data_ptr(), q_off.data_ptr(), kv_len.data_ptr(),
              o.data_ptr(), int(q.dtype == torch.bfloat16),
              int(k_pool.dtype == torch.bfloat16), B, S, H, k_pool.shape[2], hd,
              k_pool.shape[0], k_pool.shape[1], tables.shape[1], scale, _b.stream(q))
    paged_prefill_attention.launches += 1
    return o


# kernel name (the TPU kernel each replaces) -> its wrapper
KERNELS = {"paged_decode_fwd": paged_decode_attention,
           "paged_prefill_fwd": paged_prefill_attention}
for _k in KERNELS.values():
    _k.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
