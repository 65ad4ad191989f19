"""int8-compressed data-parallel gradient mean (beyond the paper); the
port of ``repro/distributed/compression.py`` over a process group.

ZeRO++-flavoured: each rank quantizes its gradient row-wise to int8 (the
paper's own Eq. 1 quantizer, ``core/quantization.quantize_rowwise``) in
blocks of 256 values, all-gathers the int8 codes and the f32 scales,
dequantizes every rank's payload and averages locally. Wire bytes drop
about 3.6x against a bf16 ring all-reduce:

    all-reduce bf16:   2·(n-1)/n · 2·D  ≈ 4·D bytes
    all-gather int8:     (n-1)/n · (D + 4·D/256) ≈ 1.1·D bytes

Error feedback (Seide et al.) keeps the quantization bias from
accumulating: the residual ``g - dequant(quant(g))`` is added to the next
step's gradient.

A library, as in the JAX package: ``ParallelConfig.grad_compression``
names it and no train step reads it. The mean adds the ranks' dequantized
payloads in rank order and divides once, the reference's order (a
reduction over the gathered axis), so it is the reference's result bit
for bit.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import quantization as Q
from repro_torch.core.quantization import div
from repro_torch.models.params import tree_from_leaves, tree_leaves

BLOCK = 256


def _rowwise_for_compression(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Flatten to (rows, 256) blocks for per-block scales (tail padded)."""
    flat = g.reshape(-1).float()
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    q, s = Q.quantize_rowwise(flat.reshape(-1, BLOCK))
    return q, s, (tuple(g.shape), pad)


def _decompress(q: torch.Tensor, s: torch.Tensor, meta) -> torch.Tensor:
    shape, pad = meta
    flat = Q.dequantize_rowwise(q, s).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in rank order."""
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack(out)


def compressed_allreduce_mean(g: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``g`` over the ranks of ``group`` (default: every rank) with
    int8 on the wire. Every rank calls it with its own ``g``; every rank
    gets the same mean (f32, ``g``'s shape)."""
    q, s, (shape, pad) = _rowwise_for_compression(g)
    deq = Q.dequantize_rowwise(_all_gather(q, group), _all_gather(s, group))  # (n, rows, 256)
    acc = deq[0]
    for d in deq[1:]:
        acc = acc + d
    flat = div(acc, float(deq.shape[0])).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compressed_tree_allreduce_mean(grads, group=None, error_feedback=None):
    """Tree version with optional error feedback state. Returns
    ``(synced_grads, new_error_feedback)``; leaves in sorted key order,
    the order every rank issues the collectives in."""
    leaves = tree_leaves(grads)
    if error_feedback is not None:
        leaves = [g.float() + e for g, e in zip(leaves, tree_leaves(error_feedback))]
    synced, resid = [], []
    for g in leaves:
        local_deq = _decompress(*_rowwise_for_compression(g))
        synced.append(compressed_allreduce_mean(g, group))
        resid.append(g.float() - local_deq)                  # what quant dropped
    return tree_from_leaves(grads, synced), tree_from_leaves(grads, resid)


def wire_bytes_saved(n_params: int, n_ranks: int) -> dict:
    """Analytical wire-byte comparison (the reference's formula)."""
    f = (n_ranks - 1) / n_ranks
    bf16_allreduce = 2 * f * 2 * n_params
    int8_allgather = f * (n_params + 4 * n_params / 256)
    return {"bf16_allreduce": bf16_allreduce,
            "int8_allgather": int8_allgather,
            "reduction": bf16_allreduce / int8_allgather}
