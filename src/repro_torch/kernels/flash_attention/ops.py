"""Public wrappers for the flash-attention kernels: dispatch by device,
and the differentiable ``flash_attention`` for training.

Model layout, as the JAX package's ``repro/kernels/flash_attention/ops.py``
speaks it: q (B, Sq, H, hd), k/v (B, Sk, KV, hd) with H a multiple of KV
(GQA: KV heads stay folded, query head h reads KV head ``h // (H/KV)``);
outputs match q.

A tensor on the CPU goes to the plain version in ``ref.py``. A tensor on
the card goes to the hand-written CUDA kernel (``csrc/flash_attention.cu``),
or the wrapper raises: there is no switch that sends a CUDA tensor to the
plain version, and no fallback when the build or a launch fails. The
kernels read the model layout through their own offsets and mask ragged
edges themselves, so unlike the JAX ops nothing is transposed or padded,
and they choose their own tiles (no block sizes here).

Each wrapper counts its kernel's launches in a plain int attribute
(``flash_fwd_lse.launches`` ...), incremented only where it launches;
``launch_counts`` (keyed by kernel name) and ``reset_launch_counts`` read
and zero them all.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build as _b
from repro_torch.kernels.flash_attention import ref as _ref

_FLOAT_TYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128       # the kernels keep hd / 32 values per lane
MAX_GROUP = 8            # decode keeps the query group's rows in registers


def softmax_scale(hd: int) -> float:
    """1 / sqrt(hd) as a Python float, as the JAX ops compute it; it is
    applied to q in f32 before the product."""
    return 1.0 / math.sqrt(hd)


def _check_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    B, _, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "do not match")
    if H % k.shape[2]:
        raise ValueError(f"GQA needs H % KV == 0, got {H} % {k.shape[2]}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} not in [1, {MAX_HEAD_DIM}]")


def _kv_valid(kv_valid, Sk: int) -> int:
    kv_valid = Sk if kv_valid is None else int(kv_valid)
    if not 1 <= kv_valid <= Sk:
        raise ValueError(f"kv_valid {kv_valid} not in [1, Sk={Sk}]")
    return kv_valid


def _lib():
    from repro_torch.kernels.flash_attention.build import load
    return load()


def flash_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, kv_valid: Optional[int] = None):
    """Softmax attention: q (B, Sq, H, hd), k/v (B, Sk, KV, hd), all f32 or
    all bf16 -> (o (B, Sq, H, hd) in q's dtype, lse (B, H, Sq) f32).

    Keys at or past ``kv_valid`` (default Sk; 1 <= kv_valid <= Sk) are
    masked; with ``causal`` query i sees keys j <= i."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _b.need(t, name, _FLOAT_TYPES, 4)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    _check_heads(q, k, v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kv_valid = _kv_valid(kv_valid, Sk)
    scale = softmax_scale(hd)
    if _b.on_cpu(q, k, v):
        return _ref.mha_fwd(q, k, v, causal=causal, kv_valid=kv_valid, scale=scale)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _b.launch(_lib().fa_flash_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
              o.data_ptr(), lse.data_ptr(), int(q.dtype == torch.bfloat16),
              B, Sq, Sk, H, KV, hd, kv_valid, int(bool(causal)), scale, _b.stream(q))
    flash_fwd_lse.launches += 1
    return o, lse


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Single-query attention over the (ring) KV cache.

    q (B, 1, H, hd); k, v (B, S_max, KV, hd) in the cache's storage layout
    (a layer's view of the stacked cache is contiguous); kv_len (B,) int32
    live cells per slot (``min(length + 1, S_max)``, so a wrapped slot
    attends over the whole window). q and the cache may differ in dtype
    (f32 compute over a bf16 cache). Returns (B, 1, H, hd) in q's dtype.
    A slot walks only its live key tiles."""
    _b.need(q, "q", _FLOAT_TYPES, 4)
    _b.need(k, "k", _FLOAT_TYPES, 4)
    _b.need(v, "v", _FLOAT_TYPES, 4)
    _b.need(kv_len, "kv_len", (torch.int32,), 1)
    if k.dtype != v.dtype:
        raise TypeError(f"k, v dtypes differ: {k.dtype}, {v.dtype}")
    _check_heads(q, k, v)
    B, one, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if one != 1:
        raise ValueError(f"decode takes one query per slot, got q {tuple(q.shape)}")
    if kv_len.shape[0] != B:
        raise ValueError(f"kv_len {tuple(kv_len.shape)} != ({B},)")
    if H // KV > MAX_GROUP:
        raise ValueError(f"query group {H // KV} > {MAX_GROUP}")
    scale = softmax_scale(hd)
    if _b.on_cpu(q, k, v, kv_len):
        return _ref.decode_fwd(q, k, v, kv_len, scale=scale)
    o = torch.empty_like(q)
    _b.launch(_lib().fa_decode_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
              kv_len.data_ptr(), o.data_ptr(), int(q.dtype == torch.bfloat16),
              int(k.dtype == torch.bfloat16), B, S, H, KV, hd, scale, _b.stream(q))
    decode_attention.launches += 1
    return o


def _check_bwd(q, k, v, do, lse, di):
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (do, "do")):
        _b.need(t, name, _FLOAT_TYPES, 4)
    if not (q.dtype == k.dtype == v.dtype == do.dtype):
        raise TypeError(f"q, k, v, do dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}")
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} != q {tuple(q.shape)}")
    _check_heads(q, k, v)
    B, Sq, H, _ = q.shape
    for t, name in ((lse, "lse"), (di, "di")):
        _b.need(t, name, (torch.float32,), 3)
        if tuple(t.shape) != (B, H, Sq):
            raise ValueError(f"{name} {tuple(t.shape)} != {(B, H, Sq)}")


def flash_bwd_dq(q, k, v, do, lse, di, *, causal: bool,
                 kv_valid: Optional[int] = None) -> torch.Tensor:
    """dq of softmax attention, recomputing p from (q, k, lse): q, do
    (B, Sq, H, hd), k/v (B, Sk, KV, hd), all f32 or all bf16; lse (the
    forward's) and di = sum_d o * do, both (B, H, Sq) f32. Returns dq
    (B, Sq, H, hd) f32."""
    _check_bwd(q, k, v, do, lse, di)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kv_valid = _kv_valid(kv_valid, Sk)
    scale = softmax_scale(hd)
    if _b.on_cpu(q, k, v, do, lse, di):
        return _ref.flash_bwd_dq(q, k, v, do, lse, di, causal=causal,
                                 kv_valid=kv_valid, scale=scale)
    dq = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    _b.launch(_lib().fa_flash_bwd_dq, q.data_ptr(), k.data_ptr(), v.data_ptr(),
              do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
              int(q.dtype == torch.bfloat16), B, Sq, Sk, H, KV, hd, kv_valid,
              int(bool(causal)), scale, _b.stream(q))
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, di, *, causal: bool,
                  kv_valid: Optional[int] = None):
    """dk and dv of softmax attention, summed over each KV head's query
    group: same inputs as :func:`flash_bwd_dq`; returns (dk, dv), each
    (B, Sk, KV, hd) f32. Keys at or past ``kv_valid`` get 0."""
    _check_bwd(q, k, v, do, lse, di)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kv_valid = _kv_valid(kv_valid, Sk)
    scale = softmax_scale(hd)
    if _b.on_cpu(q, k, v, do, lse, di):
        return _ref.flash_bwd_dkv(q, k, v, do, lse, di, causal=causal,
                                  kv_valid=kv_valid, scale=scale)
    dk = torch.empty((B, Sk, KV, hd), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    _b.launch(_lib().fa_flash_bwd_dkv, q.data_ptr(), k.data_ptr(), v.data_ptr(),
              do.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
              dv.data_ptr(), int(q.dtype == torch.bfloat16), B, Sq, Sk, H, KV, hd,
              kv_valid, int(bool(causal)), scale, _b.stream(q))
    flash_bwd_dkv.launches += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``make_flash_attention`` custom VJP: the forward
    kernel saves (q, k, v, o, lse); the backward computes di in f32 outside
    the kernels (``_bwd_impl``), runs the two backward kernels and casts
    dq, dk, dv once from f32 to the input dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd_lse(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        di = _ref.attention_di(o, do)
        dq = flash_bwd_dq(q, k, v, do, lse, di, causal=ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, causal=ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """Differentiable softmax attention, model layout: q (B, Sq, H, hd),
    k/v (B, Sk, KV, hd) with KV heads folded; returns o like q. Gradients
    flow to q, k and v through the backward kernels."""
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                 bool(causal))


# kernel name (the TPU kernel each replaces) -> its wrapper
KERNELS = {"flash_fwd": flash_fwd_lse, "decode_fwd": decode_attention,
           "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv}
for _k in KERNELS.values():
    _k.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
