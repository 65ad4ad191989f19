#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure:

1. environment: the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, the TF32 flags (both left False);
2. build: compile both kernel libraries from this checkout with nvcc, in
   parallel (``csrc/switchback.cu``, ``csrc/flash_attention.cu``);
3. kernels vs plain, at the serve path's shapes: each SwitchBack kernel
   bit-equal to its plain PyTorch version (decode rows 8, prefill rows
   1024, K in {960, 2560}, M in {320, 960, 2560}, exact half-way ties and
   an all-zero row); each flash kernel within a stated tolerance of its
   plain version (one full softmax where the kernel takes an online one)
   in bf16 and f32: prefill at 8 slots, Sq in {32, 64, 96, 128}, causal
   and full, and Sk > Sq with kv_valid < Sk; decode at S_max in {96, 256}
   with slot lengths 1, 2, 127, 128, 129, 200 and S_max in one batch. A
   control fault (KV head h % KV instead of h // group) must read at
   least 10x outside the tolerance;
4. serve: full-width smollm-360m (32 layers, d 960, vocab 49152; random
   weights from a seeded torch.Generator) through the ring-cache
   ``ServeEngine`` with ``quant_mode="int8_switchback"`` and the engine's
   default ``attn_impl="flash_scan"``: a warm-up, then a timed
   ``generate`` of 16 requests (prompts of 32-96 tokens, 32 new tokens).
   Every kernel's launch counter is zeroed just before the timed run and
   must be exactly what the run's prefill and decode calls imply just
   after (flash_fwd 32 per prefill call, decode_fwd 32 per decode step);
5. whole model, kernels vs plain: the served engine's logits (prefill
   plus three decode steps) with the kernels and with the plain versions
   swapped in on the card: with ``attn_impl="dense"`` (the four SwitchBack
   kernels) bit-equal, with ``flash_scan`` (all six) within a stated
   tolerance;
6. reference: the same engine at full width and two layers on the card
   and on the CPU (plain versions, which the CPU tests hold against the
   JAX package), prefill plus three decode steps, under ``dense`` and
   ``flash_scan``: card kernels against card plain (bit-equal under
   dense, within tolerance under flash_scan), card within stated
   tolerances of the CPU, and a control fault on the CPU (KV heads tiled
   instead of repeated) outside them;
7. decode profile, under ``flash_scan`` and ``dense`` in turns (flash,
   dense, dense, flash): one decode step's wall time, its wrapper
   launches (counted over ten steps, each kernel exactly its per-layer
   count times the layers), its device time and CUDA launches by kernel
   (torch.profiler), at the serve run's batch;
8. timing: each kernel, its plain version and (where one exists) one
   PyTorch library call, with CUDA events at the path's shapes, beside
   the least time the card could take (bytes over 3.35 TB/s, operations
   over the peak for their type).

The line before the last holds ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (dense): HBM bandwidth, int8 and bf16
# tensor-core ops, f32 ops outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

SB_SOURCE = "src/repro_torch/kernels/switchback/csrc/switchback.cu"
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SOURCE = {"tensor_quantize": SB_SOURCE, "fused_switchback_fwd": SB_SOURCE,
          "row_quantize": SB_SOURCE, "int8_matmul_dequant": SB_SOURCE,
          "flash_fwd": FA_SOURCE, "decode_fwd": FA_SOURCE}
REPLACES = {
    "tensor_quantize": "src/repro/kernels/switchback/switchback.py:124",
    "fused_switchback_fwd": "src/repro/kernels/switchback/switchback.py:269",
    "row_quantize": "src/repro/kernels/switchback/switchback.py:44",
    "int8_matmul_dequant": "src/repro/kernels/switchback/switchback.py:197",
    "flash_fwd": "src/repro/kernels/flash_attention/flash_attention.py:123",
    "decode_fwd": "src/repro/kernels/flash_attention/flash_attention.py:384",
}
# launches per layer per model call (prefill or decode step): every
# linear quantizes its weight; wq, wk, wv, wo, w_up, w_gate contract over
# K = 960 <= 2048 (fused); w_down over K = 2560 (row_quantize + matmul)
PER_LAYER = {"tensor_quantize": 7, "fused_switchback_fwd": 6,
             "row_quantize": 1, "int8_matmul_dequant": 1}
# under flash_scan: launches per layer per prefill call and per decode step
FLASH_PER_LAYER = {"flash_fwd": {"prefill": 1, "decode": 0},
                   "decode_fwd": {"prefill": 0, "decode": 1}}
# flash kernel vs plain: o relative to max|o| (one bf16 ulp at the largest
# value in bf16), lse absolute; the control fault must read 10x outside
FLASH_O_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
FLASH_LSE_TOL = 1e-5
FAULT_MARGIN = 10.0

DECODE_ROWS, PREFILL_ROWS = 8, 8 * 128


class Failure(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise Failure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs at the path's shapes
# ---------------------------------------------------------------------------

def path_shapes(cfg):
    """The (K, M) of every linear of one layer, in call order."""
    D, FF = cfg.d_model, cfg.d_ff
    Hd, KVd = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    return {"wq": (D, Hd), "wk": (D, KVd), "wv": (D, KVd), "wo": (Hd, D),
            "w_up": (D, FF), "w_gate": (D, FF), "w_down": (FF, D)}


def activations(torch, gen, R, K, dev, dtype=None):
    """Random bf16-valued rows; row 1 holds exact half-way ties at scale 1
    (absmax 127), row 2 is all zero."""
    dtype = dtype or torch.bfloat16
    x = torch.randn((R, K), generator=gen, device=dev) * 3
    ties = (torch.arange(K, device=dev, dtype=torch.float32) % 8) - 3.5
    ties[0] = 127.0
    x[1] = ties
    x[2] = 0.0
    return x.to(torch.bfloat16).to(dtype)


def weight(torch, gen, K, M, dev, ties=False):
    """A bf16 weight as ``use_weight`` hands it to the quantizer. With
    ``ties`` the absmax is 127/128, so the scale is exactly 128 and the
    odd multiples of 1/256 land on .5."""
    w = torch.randn((K, M), generator=gen, device=dev) / K ** 0.5
    if ties:
        w[0, 0] = 127.0 / 128.0
        w[1, :16] = (2 * torch.arange(16, device=dev, dtype=torch.float32) - 15) / 256
    return w.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def max_abs_diff(torch, a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def compare_kernels(torch, KOPS, REF, cfg, dev, seed):
    """Bitwise kernel-vs-plain at the path's shapes. Returns the largest
    |kernel - plain| per kernel (0.0 when bit-equal)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = {k: 0.0 for k in PER_LAYER}
    n = 0

    def same(name, got, ref, what):
        nonlocal n
        d = max_abs_diff(torch, got, ref)
        worst[name] = max(worst[name], d)
        check(got.dtype == ref.dtype and got.shape == ref.shape
              and torch.equal(got, ref),
              f"{name} {what}: kernel != plain (max |diff| {d:g})")
        n += 1

    wq = {}
    for lin, (K, M) in path_shapes(cfg).items():
        for ties in (False, True):
            w = weight(torch, gen, K, M, dev, ties)
            q, s = KOPS.tensor_quantize(w)
            rq, rs = REF.tensor_quantize(w)
            same("tensor_quantize", q, rq, f"{lin} {tuple(w.shape)} ties={ties}")
            same("tensor_quantize", s, rs, f"{lin} state")
            wq[lin] = (q, s)
    # f32 compute hands the quantizer the f32 master weight itself
    w = torch.randn((960, 2560), generator=gen, device=dev) / 960 ** 0.5
    same("tensor_quantize", KOPS.tensor_quantize(w)[0], REF.tensor_quantize(w)[0],
         "f32 (960, 2560)")
    zero = torch.zeros((960, 320), dtype=torch.bfloat16, device=dev)
    same("tensor_quantize", KOPS.tensor_quantize(zero)[1],
         REF.tensor_quantize(zero)[1], "all-zero state")

    for R in (DECODE_ROWS, PREFILL_ROWS):
        for dt in (torch.bfloat16, torch.float32):
            for lin in ("wq", "wk", "wo", "w_up"):
                K = wq[lin][0].shape[0]
                x = activations(torch, gen, R, K, dev, dt)
                same("fused_switchback_fwd",
                     KOPS.fused_switchback_fwd(x, *wq[lin]),
                     REF.fused_switchback_fwd(x, *wq[lin]),
                     f"{lin} R={R} {dt}")
            w_q, s_w = wq["w_down"]
            x = activations(torch, gen, R, w_q.shape[0], dev, dt)
            x_q, s_x = KOPS.row_quantize(x)
            rxq, rsx = REF.row_quantize(x)
            same("row_quantize", x_q, rxq, f"R={R} {dt}")
            same("row_quantize", s_x, rsx, f"state R={R} {dt}")
            scale = s_x * REF.div(s_w, 127.0 * 127.0)
            same("int8_matmul_dequant",
                 KOPS.int8_matmul_dequant(x_q, w_q, scale, out_dtype=dt),
                 REF.int8_matmul_dequant(x_q, w_q, scale, out_dtype=dt),
                 f"w_down R={R} {dt}")
    torch.cuda.synchronize()
    return worst, n


def rel_err(torch, got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def plain_flash_fwd(M):
    """The plain version behind the wrapper's signature."""
    def fwd(q, k, v, *, causal, kv_valid=None):
        return M.FREF.mha_fwd(q, k, v, causal=causal,
                              kv_valid=k.shape[1] if kv_valid is None else kv_valid,
                              scale=M.FA.softmax_scale(q.shape[-1]))
    return fwd


def plain_decode(M):
    def dec(q, k, v, kv_len):
        return M.FREF.decode_fwd(q, k, v, kv_len, scale=M.FA.softmax_scale(q.shape[-1]))
    return dec


def kv_heads_by_modulo(k, n_heads):
    """The control fault's K/V: (B, S, KV, hd) -> (B, S, H, hd) with query
    head h reading KV head h % KV instead of h // group (the KV heads
    tiled, 0,1,2,0,1,2, where the model repeats each, 0,0,1,1,2,2)."""
    return k.repeat(1, 1, n_heads // k.shape[2], 1)


def compare_flash(torch, M, cfg, dev, seed):
    """Each flash kernel against its plain version on the card at the
    path's shapes and edges, bf16 and f32, within FLASH_O_TOL /
    FLASH_LSE_TOL; the control fault must read FAULT_MARGIN x outside.
    Returns per kernel the largest |kernel - plain| and relative error,
    the smallest fault/tolerance ratio, and the number of comparisons."""
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scale = M.FA.softmax_scale(hd)
    out = {k: dict(max_abs_err=0.0, max_rel_err=0.0, max_lse_err=0.0,
                   fault_over_tol=math.inf) for k in ("flash_fwd", "decode_fwd")}
    n = 0

    def record(name, dt, got, want, fault, what, lse=None):
        nonlocal n
        r = out[name]
        tol = FLASH_O_TOL[str(dt).replace("torch.", "")]
        err = rel_err(torch, got, want)
        r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(torch, got, want))
        r["max_rel_err"] = max(r["max_rel_err"], err)
        check(got.dtype == want.dtype and got.shape == want.shape
              and bool(torch.isfinite(got).all()), f"{name} {what}: bad output")
        check(err <= tol, f"{name} {what}: kernel vs plain {err:g} > {tol:g}")
        if lse is not None:
            e = float((lse[0] - lse[1]).abs().max())
            r["max_lse_err"] = max(r["max_lse_err"], e)
            check(e <= FLASH_LSE_TOL, f"{name} {what}: lse off by {e:g} > {FLASH_LSE_TOL:g}")
        if fault is not None:
            f = rel_err(torch, got, fault) / tol
            r["fault_over_tol"] = min(r["fault_over_tol"], f)
            check(f >= FAULT_MARGIN, f"{name} {what}: the control fault reads only {f:g} x "
                  "the tolerance, which so could barely see it")
        n += 1

    def rand(*shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    for dt in (torch.bfloat16, torch.float32):
        cases = [(8, S, S, S, c) for S in (32, 64, 96, 128) for c in (True, False)]
        cases += [(8, 64, 160, 150, c) for c in (True, False)]
        for B, Sq, Sk, kv_valid, causal in cases:
            q, k, v = rand(B, Sq, H, hd, dt=dt), rand(B, Sk, KV, hd, dt=dt), rand(B, Sk, KV, hd, dt=dt)
            o, lse = M.FA.flash_fwd_lse(q, k, v, causal=causal, kv_valid=kv_valid)
            ro, rlse = M.FREF.mha_fwd(q, k, v, causal=causal, kv_valid=kv_valid, scale=scale)
            fo, _ = M.FREF.mha_fwd(q, kv_heads_by_modulo(k, H),
                                   kv_heads_by_modulo(v, H), causal=causal,
                                   kv_valid=kv_valid, scale=scale)
            record("flash_fwd", dt, o, ro, fo,
                   f"B{B} Sq{Sq} Sk{Sk} kv_valid{kv_valid} causal={causal} {dt}", (lse, rlse))
        for S in (96, 256):
            lens = torch.tensor([1, 2, 127, 128, 129, 200, S, S], dtype=torch.int32,
                                device=dev).clamp(max=S)
            for cache_dt in dict.fromkeys((torch.bfloat16, dt)):
                q = rand(8, 1, H, hd, dt=dt)
                k, v = rand(8, S, KV, hd, dt=cache_dt), rand(8, S, KV, hd, dt=cache_dt)
                o = M.FA.decode_attention(q, k, v, lens)
                ro = M.FREF.decode_fwd(q, k, v, lens, scale=scale)
                fo = M.FREF.decode_fwd(q, kv_heads_by_modulo(k, H),
                                       kv_heads_by_modulo(v, H), lens, scale=scale)
                record("decode_fwd", dt, o, ro, fo,
                       f"S_max{S} lens {lens.tolist()} q {dt} cache {cache_dt}")
    torch.cuda.synchronize()
    return out, n


# ---------------------------------------------------------------------------
# phase 7: timing
# ---------------------------------------------------------------------------

def graph_ms(torch, fn, n_sets, reps=20):
    """Device ms per ``fn(i)``: the calls for all ``n_sets`` input sets (more
    bytes than the 50 MB L2, as a decode step finds each layer's weights
    cold) captured once in a CUDA graph and replayed ``reps`` times, so the
    time is the card's and not the host's launch rate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up outside capture
        for i in range(n_sets):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_sets):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * n_sets)


def eager_ms(torch, fn, n_sets, iters=30):
    """ms per ``fn(i)`` called eagerly, as the engine calls it: CUDA events
    around the calls, so the host's launch time counts where it is longer
    than the card's work."""
    for i in range(n_sets):
        fn(i)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i % n_sets)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(bytes_, int8_ops=0.0, f32_ops=0.0, bf16_ops=0.0):
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = (int8_ops / INT8_OPS_PER_S + bf16_ops / BF16_OPS_PER_S
             + f32_ops / F32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_kernels(torch, KOPS, REF, cfg, dev, seed, R):
    """One layer's calls of each kernel at ``R`` rows (the calls one decode
    step (R=8) or one prefill (R=1024) makes per layer): the kernel, its
    plain version and a library call, with the bound for the same work."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = path_shapes(cfg)
    fused = [k for k in shapes if k != "w_down"]
    D, FF = cfg.d_model, cfg.d_ff
    K, M = shapes["w_down"]
    layer_w = sum(k * m for k, m in shapes.values())
    n_sets = max(2, int(120e6 // (layer_w * 3 + R * (D + FF) * 2)) + 1)
    sets = []
    for _ in range(n_sets):
        ws = {k: weight(torch, gen, *km, dev) for k, km in shapes.items()}
        qs = {k: KOPS.tensor_quantize(w) for k, w in ws.items()}
        xd = activations(torch, gen, R, FF, dev)
        x_q, s_x = KOPS.row_quantize(xd)
        sets.append(dict(ws=ws, qs=qs, x=activations(torch, gen, R, D, dev), xd=xd,
                         x_q=x_q, scale=s_x * REF.div(qs["w_down"][1], 127.0 * 127.0)))
    torch.cuda.synchronize()
    # the library yardstick for int8_matmul_dequant: torch._int_mm
    # (cuBLASLt int8) plus the row scale. It needs more than 16 rows, so
    # below that its input is zero-padded to 32 rows.
    pad = 32 - R if R <= 16 else 0

    def int_mm(s):
        xq = torch.cat([s["x_q"], s["x_q"].new_zeros((pad, K))]) if pad else s["x_q"]
        acc = torch._int_mm(xq, s["qs"]["w_down"][0])[:R]
        return (acc.float() * s["scale"]).to(torch.bfloat16)

    s0 = sets[0]
    check(torch.equal(int_mm(s0), KOPS.int8_matmul_dequant(s0["x_q"], s0["qs"]["w_down"][0],
                                                           s0["scale"])),
          "torch._int_mm yardstick disagrees with int8_matmul_dequant")

    n = layer_w
    work = {
        # name: (calls, call(set, ops module), library call, bytes, int8 ops, f32 ops)
        "tensor_quantize": (
            7, lambda s, op: [op.tensor_quantize(w) for w in s["ws"].values()], None,
            n * 2 + n + 7 * 4, 0, 4 * n),
        "fused_switchback_fwd": (
            len(fused),
            lambda s, op: [op.fused_switchback_fwd(s["x"], *s["qs"][k]) for k in fused], None,
            sum(R * shapes[k][0] * 2 + shapes[k][0] * shapes[k][1] + 4 + R * shapes[k][1] * 2
                for k in fused),
            sum(2 * R * shapes[k][0] * shapes[k][1] for k in fused), 4 * R * D * len(fused)),
        "row_quantize": (
            1, lambda s, op: op.row_quantize(s["xd"]), None,
            R * FF * 2 + R * FF + R * 4, 0, 4 * R * FF),
        "int8_matmul_dequant": (
            1, lambda s, op: op.int8_matmul_dequant(s["x_q"], s["qs"]["w_down"][0], s["scale"]),
            int_mm, R * K + K * M + R * 4 + R * M * 2, 2 * R * K * M, 0),
    }
    out = {}
    for name, (calls, call, library, bytes_, i8, f32) in work.items():
        r = dict(calls=calls, bound=bound(bytes_, int8_ops=i8, f32_ops=f32))
        r["ms"] = graph_ms(torch, lambda i: call(sets[i], KOPS), n_sets)
        r["plain_ms"] = graph_ms(torch, lambda i: call(sets[i], REF), n_sets)
        r["library_ms"] = (graph_ms(torch, lambda i: library(sets[i]), n_sets)
                           if library else None)
        r["eager_ms"] = eager_ms(torch, lambda i: call(sets[i], KOPS), n_sets)
        if library:
            r["library_rows"] = R + pad
        out[name] = r
    return out


def time_flash(torch, M, cfg, dev, seed, served_lens):
    """Each flash kernel at the path's shapes: flash_fwd at one prefill
    call's shape (8 slots x 128, causal), decode_fwd at one decode step's
    (8 slots, S_max 256) with every slot at S_max and at ``served_lens``.
    Per case: the kernel, its plain version, its eager time, the library
    call (SDPA with GQA, a boolean key mask for decode) and the bound:
    bytes (each input read once, each output written once; for decode the
    live cache cells only) against the matmul operations of the live
    (query, key) pairs at the bf16 tensor-core peak."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bf = torch.bfloat16
    B, S = 8, 128

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def sets_for(per_set_bytes, make):
        return [make() for _ in range(max(2, int(120e6 // per_set_bytes) + 1))]

    def sdpa_fwd(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True,
                                              enable_gqa=True).transpose(1, 2)

    def sdpa_decode(q, k, v, mask):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=mask,
                                              enable_gqa=True).transpose(1, 2)

    def timed(fn, plain, library, sets, bytes_, flops, work):
        n = len(sets)
        return dict(ms=graph_ms(torch, lambda i: fn(*sets[i]), n),
                    plain_ms=graph_ms(torch, lambda i: plain(*sets[i]), n),
                    library_ms=graph_ms(torch, lambda i: library(*sets[i]), n),
                    eager_ms=eager_ms(torch, lambda i: fn(*sets[i]), n),
                    bound=bound(bytes_, bf16_ops=flops), work=work, calls=1)

    out = {}
    qkv_bytes = (B * S * H * hd + 2 * B * S * KV * hd) * 2
    pf_sets = sets_for(qkv_bytes, lambda: (rand(B, S, H, hd), rand(B, S, KV, hd),
                                           rand(B, S, KV, hd)))
    o = M.FA.flash_fwd_lse(*pf_sets[0], causal=True)[0]
    sdpa_err = rel_err(torch, sdpa_fwd(*pf_sets[0]), o)
    check(sdpa_err <= 2e-2, f"SDPA yardstick disagrees with flash_fwd ({sdpa_err:g})")
    pairs = B * H * S * (S + 1) // 2                      # causal live pairs
    plain_fwd = plain_flash_fwd(M)
    out["flash_fwd"] = timed(
        lambda q, k, v: M.FA.flash_fwd_lse(q, k, v, causal=True),
        lambda q, k, v: plain_fwd(q, k, v, causal=True), sdpa_fwd, pf_sets,
        qkv_bytes + B * S * H * hd * 2 + B * H * S * 4, 4.0 * pairs * hd,
        f"one prefill call per layer: {B} slots x {S} tokens, causal, bf16")
    out["flash_fwd"]["sdpa_rel_err"] = sdpa_err

    S_max = 256
    plain_dec = plain_decode(M)
    for tag, lens in (("full", [S_max] * B), ("served", served_lens)):
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        mask = (torch.arange(S_max, device=dev)[None, :] < lens_t[:, None])[:, None, None, :]
        dec_sets = sets_for(2 * B * S_max * KV * hd * 2, lambda: (
            rand(B, 1, H, hd), rand(B, S_max, KV, hd), rand(B, S_max, KV, hd)))
        live = sum(lens)
        r = timed(lambda q, k, v: M.FA.decode_attention(q, k, v, lens_t),
                  lambda q, k, v: plain_dec(q, k, v, lens_t),
                  lambda q, k, v: sdpa_decode(q, k, v, mask), dec_sets,
                  2 * B * H * hd * 2 + live * KV * hd * 2 * 2 + B * 4,
                  4.0 * live * H * hd,
                  f"one decode step per layer: {B} slots, S_max {S_max}, lengths {lens}")
        r["sdpa_rel_err"] = rel_err(torch, sdpa_decode(*dec_sets[0], mask),
                                    M.FA.decode_attention(*dec_sets[0], lens_t))
        check(r["sdpa_rel_err"] <= 2e-2,
              f"SDPA yardstick disagrees with decode_fwd ({r['sdpa_rel_err']:g})")
        out[f"decode_fwd_{tag}"] = r
    return out


# ---------------------------------------------------------------------------
# phases 4-6: the serve path
# ---------------------------------------------------------------------------

# whole model under flash_scan, kernels against plain and card against CPU:
# (max, mean) |difference| relative to max|logit|. The online softmax sums
# in another order than the plain version's one full softmax; the int8
# quantizers amplify such last-bit differences (an activation on the other
# side of a rounding boundary moves its row's product by one quantization
# step), most in f32. The control fault (KV heads tiled) must land outside.
FLASH_MODEL_TOL = {"float32": (5e-2, 5e-3), "bfloat16": (2e-2, 1e-3)}
# the same for the served engine at full depth (32 layers, bf16), which
# carries such a difference through 16x more quantized linears: two exact
# plain formulations of the same attention (flash's and dense's) already
# read about 3e-2 / 2e-3 apart there (phase 5 prints this yardstick)
SERVED_FLASH_TOL = (1e-1, 1.5e-2)


def launch_counts(M) -> dict:
    return {**M.KOPS.launch_counts(), **M.FA.launch_counts()}


def reset_launch_counts(M):
    M.KOPS.reset_launch_counts()
    M.FA.reset_launch_counts()


def expected_launches(cfg, prefill_calls: int, decode_steps: int, impl: str) -> dict:
    """Each wrapper's launches for so many model calls of the engine."""
    want = {k: per * cfg.n_layers * (prefill_calls + decode_steps)
            for k, per in PER_LAYER.items()}
    for k, per in FLASH_PER_LAYER.items():
        want[k] = 0 if impl == "dense" else cfg.n_layers * (
            per["prefill"] * prefill_calls + per["decode"] * decode_steps)
    return want


def serve(torch, M, cfg, dev, seed):
    import numpy as np

    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve import make_serve_engine

    scfg = ServeConfig(max_batch=8, max_len=256, quant_mode="int8_switchback")
    t = time.perf_counter()
    eng = make_serve_engine("smollm-360m", scfg, device=dev)   # the engine's defaults
    check(eng.parallel.attn_impl == "flash_scan",
          f"the engine's default attn_impl is {eng.parallel.attn_impl!r}")
    params = eng.init_params(seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"[serve] engine ({eng.parallel.attn_impl}) + {n_params / 1e6:.1f} M params "
          f"on {dev} in {time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(seed)
    lens = rng.integers(32, 97, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in lens]
    eng.generate(params, prompts, max_new_tokens=2)              # warm-up

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(M)
    gens, stats = eng.generate(params, prompts, max_new_tokens=32)
    counts = launch_counts(M)

    check(len(gens) == len(prompts) and all(len(g) == 32 for g in gens),
          f"not every request got 32 tokens: {[len(g) for g in gens]}")
    check(all(0 <= t < cfg.vocab_size for g in gens for t in g),
          "a token outside the vocabulary")
    want = expected_launches(cfg, stats["prefill_calls"], stats["decode_steps"],
                             eng.parallel.attn_impl)
    for k, n in want.items():
        check(counts[k] > 0, f"{k} never launched on the serve path")
        check(counts[k] == n,
              f"{k}: {counts[k]} launches, expected {n} for {cfg.n_layers} layers x "
              f"({stats['prefill_calls']} prefill calls, {stats['decode_steps']} decode steps)")
    print(f"[serve] {stats['new_tokens']} new tokens ({stats['prefill_tokens']} "
          f"prefilled) in {stats['wall_s']:.3f} s: {stats['tokens_per_s']:.1f} tok/s, "
          f"decode {stats['decode_tokens_per_s']:.1f} tok/s; "
          f"{stats['decode_steps']} decode steps, {stats['prefill_calls']} prefill calls; "
          f"ttft p50 {stats['ttft_p50_s'] * 1e3:.1f} ms p95 {stats['ttft_p95_s'] * 1e3:.1f} ms; "
          f"itl p50 {stats['itl_p50_s'] * 1e3:.2f} ms p95 {stats['itl_p95_s'] * 1e3:.2f} ms; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("[serve] launches:", json.dumps(counts))
    print("[serve] stats:", json.dumps(stats))
    print("[serve] sample:", gens[0][:12])
    return eng, params, prompts, stats, counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@contextlib.contextmanager
def swapped(patches):
    """Set ``(module, name, value)`` attributes for the block, then restore."""
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    for m, name, value in patches:
        setattr(m, name, value)
    try:
        yield
    finally:
        for m, name, value in saved:
            setattr(m, name, value)


def plain_ops(M, flash: bool):
    """Send the model's kernel calls to their plain versions, for the
    whole-model kernels-vs-plain checks only (the package has no such
    switch: its wrappers launch the kernel on a CUDA tensor or raise): the
    four SwitchBack kernels, and with ``flash`` the two flash kernels."""
    patches = [(M.KOPS, name, getattr(M.REF, name)) for name in PER_LAYER]
    if flash:
        patches += [(M.FA, "flash_fwd_lse", plain_flash_fwd(M)),
                    (M.FA, "decode_attention", plain_decode(M))]
    return swapped(patches)


def tiled_kv_heads(M):
    """The control fault in the model, a one-word wiring slip: GQA
    expansion by ``kv_heads_by_modulo`` in the dense path and in the flash
    kernels' plain versions."""
    from repro_torch.models import attention as A
    return swapped([(A, "_expand_kv", kv_heads_by_modulo),
                    (M.FREF, "_expand_heads", kv_heads_by_modulo)])


def run_logits(eng, params, toks, lens, fed=None):
    """Prefill plus three decode steps. The decode inputs are ``fed``, or
    this run's own greedy tokens when it is None. Returns the last-position
    logits of each call and the tokens the run fed itself."""
    import numpy as np
    cache = eng.init_cache()
    lg, cache = eng.prefill(params, cache, toks, lens, np.ones((len(lens),), bool))
    steps, own = [lg[:, 0]], []
    for i in range(3):
        own.append(lg[:, 0].argmax(-1).cpu().numpy()[:, None])
        lg, cache = eng.decode(params, cache, own[i] if fed is None else fed[i])
        steps.append(lg[:, 0])
    return steps, own


def rel_errs(got, want):
    """(max, mean) |got - want| relative to max|want|, worst over calls."""
    return (max(float((a.float().cpu() - b.float().cpu()).abs().max()
                      / b.float().cpu().abs().max()) for a, b in zip(got, want)),
            max(float((a.float().cpu() - b.float().cpu()).abs().mean()
                      / b.float().cpu().abs().max()) for a, b in zip(got, want)))


def prompt_batch(prompts, B, S):
    import numpy as np
    toks = np.zeros((B, S), np.int64)
    lens = np.zeros((B,), np.int32)
    for b in range(B):
        p = prompts[b][:S]
        toks[b, :len(p)] = p
        lens[b] = len(p)
    return toks, lens


def whole_model(torch, M, engines, params, prompts):
    """The served engine (full depth, bf16 compute) with the kernels and
    with the plain versions swapped in: under dense attention the logits
    are bit-equal at every call, under flash_scan within
    SERVED_FLASH_TOL. Beside it, the plain flash path against the dense
    path (both exact plain arithmetic, the softmax taken in another
    order): how far the served model carries a last-bit difference in
    attention, the yardstick the flash tolerance is read against."""
    res, plain = {}, {}
    eng = engines["flash_scan"]
    toks, lens = prompt_batch(prompts, eng.serve_cfg.max_batch, 128)
    _, fed = run_logits(engines["dense"], params, toks, lens)      # fed to every run
    for impl, e in engines.items():
        kern, _ = run_logits(e, params, toks, lens, fed)
        with plain_ops(M, flash=impl != "dense"):
            plain[impl], _ = run_logits(e, params, toks, lens, fed)
        check(all(bool(torch.isfinite(a).all()) for a in kern), f"{impl}: non-finite logits")
        rel, mean = rel_errs(kern, plain[impl])
        res[impl] = dict(bitwise=all(torch.equal(a, b) for a, b in zip(kern, plain[impl])),
                         max_rel_err=rel, mean_rel_err=mean,
                         per_call=[rel_errs([a], [b]) for a, b in zip(kern, plain[impl])],
                         argmax_agree=float(sum(float((a.argmax(-1) == b.argmax(-1)).float().mean())
                                                for a, b in zip(kern, plain[impl])) / len(kern)))
        if impl == "dense":
            check(res[impl]["bitwise"], f"served model, dense: kernel logits != plain logits "
                  f"(max |diff| per call {[max_abs_diff(torch, a, b) for a, b in zip(kern, plain[impl])]})")
        else:
            res[impl]["tolerance"] = SERVED_FLASH_TOL
            check(rel <= SERVED_FLASH_TOL[0] and mean <= SERVED_FLASH_TOL[1],
                  f"served model, {impl}: kernel vs plain logits {rel:g}/{mean:g} > "
                  f"{SERVED_FLASH_TOL[0]:g}/{SERVED_FLASH_TOL[1]:g}")
    res["plain_flash_vs_plain_dense"] = dict(zip(("max_rel_err", "mean_rel_err"),
                                                 rel_errs(plain["flash_scan"], plain["dense"])))
    print(f"[whole model] prefill + 3 decode steps, {len(lens)} slots, "
          f"{eng.cfg.n_layers} layers, kernels vs plain: " + json.dumps(res))
    return res


def reference(torch, M, cfg, dev, seed):
    """Full width, two layers, prefill + 3 decode steps on the same weights
    and tokens, under dense and flash_scan: card kernels against card plain
    (bit-equal under dense, within FLASH_MODEL_TOL under flash_scan), card
    against the CPU's plain path (within tolerance), and a control fault on
    the CPU against the CPU (outside the tolerance)."""
    import numpy as np

    from repro_torch.configs.base import ParallelConfig, ServeConfig
    from repro_torch.core.precision import QuantPolicy
    from repro_torch.models import build
    from repro_torch.models import params as PRM
    from repro_torch.serve import make_serve_engine

    small = build(dataclasses.replace(cfg, n_layers=2))
    params_cpu = PRM.init_params(small.param_specs, seed, device="cpu")
    params_dev = PRM.tree_map(lambda t: t.to(dev), params_cpu)
    rng = np.random.default_rng(seed + 1)
    B, S = 4, 64
    toks = rng.integers(0, cfg.vocab_size, size=(B, S))
    lens = np.array([64, 40, 17, 33], np.int32)
    # Tolerances (max, mean), relative to max|logit|, card against CPU.
    # Card and CPU differ in the order of sums in the attention and head
    # products and in libm ulps; the int8 quantizers amplify such last-bit
    # differences in f32, where an activation on the other side of a
    # rounding boundary moves its row's product by one quantization step.
    # bf16 absorbs most of them. The control fault (KV heads tiled) must
    # land outside both bounds.
    tolerances = {"dense": {torch.float32: (5e-2, 5e-3), torch.bfloat16: (2e-2, 1e-4)},
                  "flash_scan": {torch.float32: FLASH_MODEL_TOL["float32"],
                                 torch.bfloat16: FLASH_MODEL_TOL["bfloat16"]}}

    res = {}
    for impl, by_dtype in tolerances.items():
        for cd, tol in by_dtype.items():
            name = f"{impl}_{str(cd).replace('torch.', '')}"

            def engine(where):
                return make_serve_engine(
                    small, ServeConfig(max_batch=B, max_len=128, quant_mode="int8_switchback"),
                    parallel=ParallelConfig(remat="none", attn_impl=impl),
                    policy=QuantPolicy("int8_switchback", compute_dtype=cd), device=where)

            cpu_eng, dev_eng = engine("cpu"), engine(dev)
            cpu, fed = run_logits(cpu_eng, params_cpu, toks, lens)   # fed to every run
            with tiled_kv_heads(M):
                fault, _ = run_logits(cpu_eng, params_cpu, toks, lens, fed)
            card, _ = run_logits(dev_eng, params_dev, toks, lens, fed)
            with plain_ops(M, flash=impl != "dense"):
                card_plain, _ = run_logits(dev_eng, params_dev, toks, lens, fed)
            bitwise = all(torch.equal(a, b) for a, b in zip(card, card_plain))
            k_rel, k_mean = rel_errs(card, card_plain)
            rel, mean = rel_errs(card, cpu)
            f_rel, f_mean = rel_errs(fault, cpu)
            agree = float(np.mean([float((a.cpu().argmax(-1) == b.argmax(-1)).float().mean())
                                   for a, b in zip(card, cpu)]))
            res[name] = dict(card_kernels_eq_card_plain=bitwise,
                             card_kernels_vs_plain_max_rel_err=k_rel,
                             card_kernels_vs_plain_mean_rel_err=k_mean,
                             max_rel_err=rel, mean_rel_err=mean, tolerance=tol,
                             argmax_agree=agree, control_fault_max_rel_err=f_rel,
                             control_fault_mean_rel_err=f_mean)
            check(all(bool(torch.isfinite(a).all()) and tuple(a.shape) == (B, cfg.vocab_size)
                      for a in card), f"reference {name}: non-finite or misshapen logits")
            if impl == "dense":
                check(bitwise, f"reference {name}: card kernel logits != card plain logits")
            else:
                check(k_rel <= tol[0] and k_mean <= tol[1],
                      f"reference {name}: card kernels vs card plain {k_rel:g}/{k_mean:g} "
                      f"> {tol[0]:g}/{tol[1]:g}")
            check(rel <= tol[0] and mean <= tol[1],
                  f"reference {name}: card vs CPU max/mean rel err {rel:g}/{mean:g} "
                  f"> {tol[0]:g}/{tol[1]:g}")
            check(f_rel > tol[0] and f_mean > tol[1],
                  f"reference {name}: the control fault ({f_rel:g}/{f_mean:g}) lies within "
                  f"the tolerance {tol[0]:g}/{tol[1]:g}, which so could not see it")
    print("[reference]", json.dumps(res))
    return res


KERNEL_GROUPS = ("row_quantize", "absmax_partial", "cast_tensorwise", "fused_fwd",
                 "int8_matmul_dequant", "flash_fwd", "decode_fwd")


def decode_profile(torch, M, cfg, eng, params, prompts):
    """Wall time and wrapper launches of one full-batch decode step over 10
    steps, and the device time and CUDA launches by kernel over 5
    (torch.profiler). Also returns the batch's cache lengths at the end."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    impl = eng.parallel.attn_impl
    B = eng.serve_cfg.max_batch
    cache = eng.init_cache()
    toks, lens = prompt_batch(prompts, B, 128)
    lg, cache = eng.prefill(params, cache, toks, lens, np.ones((B,), bool))
    cur = lg[:, 0].argmax(-1).cpu().numpy()[:, None]
    for _ in range(3):
        lg, cache = eng.decode(params, cache, cur)
    torch.cuda.synchronize()
    n = 10
    reset_launch_counts(M)
    t = time.perf_counter()
    for _ in range(n):
        lg, cache = eng.decode(params, cache, cur)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / n * 1e3
    per_step = {k: v / n for k, v in launch_counts(M).items()}
    for k, want in expected_launches(cfg, 0, 1, impl).items():
        check(per_step[k] == want,
              f"{impl}: {k}: {per_step[k]} launches per decode step, expected {want}")

    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            lg, cache = eng.decode(params, cache, cur)
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us and getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type):
            by_kernel[e.key] = (us / n_prof / 1e3, e.count / n_prof)
    dev_ms = sum(v[0] for v in by_kernel.values())
    groups = {}
    for key, (ms, cnt) in by_kernel.items():
        g = next((k for k in KERNEL_GROUPS if k in key), None)
        g = g or ("gemm" if "gemm" in key.lower() or "sm90" in key.lower() else "other")
        a = groups.setdefault(g, [0.0, 0])
        a[0] += ms
        a[1] += cnt
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    prof_out = dict(
        attn_impl=impl, step_ms=step_ms, launches_per_step=per_step,
        device_ms_per_step=dev_ms,
        cuda_launches_per_step=sum(v[1] for v in by_kernel.values()),
        device_idle_share=(max(0.0, 1 - dev_ms / step_ms) if dev_ms else None),
        groups={g: {"ms": v[0], "launches": v[1]} for g, v in
                sorted(groups.items(), key=lambda kv: -kv[1][0])},
        top=[{"kernel": k[:90], "ms": v[0], "launches": v[1]} for k, v in top])
    if not dev_ms:
        print(f"[profile] {impl}: torch.profiler saw no device time; step wall time only")
    print("[profile]", json.dumps(prof_out))
    lengths = next(iter(cache.values())).length[0].tolist()
    return prof_out, lengths


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.kernels.flash_attention import build as FB
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FREF
    from repro_torch.kernels.switchback import build as KB
    from repro_torch.kernels.switchback import ops as KOPS
    from repro_torch.kernels.switchback import ref as REF
    from repro_torch.serve import make_serve_engine
    M = types.SimpleNamespace(KOPS=KOPS, REF=REF, FA=FA, FREF=FREF)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # 1. environment
    smi = nvidia_smi_line()
    print(smi)
    # full-precision products, as the JAX package computes them: no TF32,
    # and bf16 GEMMs reduce in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}; bf16 reduced-precision reduction "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    # 2. build: one nvcc per source, started together
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = {lib: pool.submit(mod.build) for lib, mod in
                  (("switchback", KB), ("flash_attention", FB))}
        built = {lib: f.result() for lib, f in builds.items()}
    KB.load()
    FB.load()
    print(f"[build] both libraries in {time.perf_counter() - t:.1f} s")
    for lib, (lib_path, log) in built.items():
        print(f"[build] {os.path.relpath(lib_path, ROOT)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib}:", line.strip())

    cfg = get_config("smollm-360m")
    # 3. kernels vs plain
    worst, n_cmp = compare_kernels(torch, KOPS, REF, cfg, dev, args.seed)
    print(f"[kernels] {n_cmp} SwitchBack comparisons bit-equal; max |kernel - plain| "
          + json.dumps(worst))
    flash_worst, n_flash = compare_flash(torch, M, cfg, dev, args.seed)
    print(f"[kernels] {n_flash} flash comparisons within o {json.dumps(FLASH_O_TOL)} of "
          f"max|o|, lse {FLASH_LSE_TOL:g}; control fault >= {FAULT_MARGIN:g}x the "
          "tolerance: " + json.dumps(flash_worst))

    # 4. serve (the main path)
    eng, params, prompts, stats, counts = serve(torch, M, cfg, dev, args.seed)
    engines = {"flash_scan": eng, "dense": make_serve_engine(
        "smollm-360m", eng.serve_cfg, parallel=ParallelConfig(remat="none", attn_impl="dense"),
        device=dev)}
    # 5. whole model, kernels vs plain
    whole_model(torch, M, engines, params, prompts)
    # 6. reference
    reference(torch, M, cfg, dev, args.seed)
    # 7. decode profile, the two attention paths in turns on the same card
    profs = {"flash_scan": [], "dense": []}
    for impl in ("flash_scan", "dense", "dense", "flash_scan"):
        p, lengths = decode_profile(torch, M, cfg, engines[impl], params, prompts)
        profs[impl].append(p)
        if impl == "flash_scan":
            served_lens = lengths
    prof = profs["flash_scan"][0]
    del eng, engines, params
    torch.cuda.empty_cache()

    # 8. timing
    rows = {}
    for R in (PREFILL_ROWS, DECODE_ROWS):
        rows[R] = time_kernels(torch, KOPS, REF, cfg, dev, args.seed, R)
    flash_t = time_flash(torch, M, cfg, dev, args.seed, served_lens)
    print("[timing] flash:", json.dumps(flash_t))
    calls = stats["decode_steps"] + stats["prefill_calls"]

    def entry(name, r, err):
        b_ms, b_by = r["bound"]
        return dict(name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
                    launches=counts[name],
                    launches_per_decode_step=prof["launches_per_step"][name],
                    max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b_ms,
                    bound_by=b_by, library_ms=r["library_ms"], eager_ms=r["eager_ms"],
                    calls_timed=r["calls"], work=r.get("work"))

    def entries(R):
        out = []
        for name, r in rows[R].items():
            e = entry(name, r, worst[name])
            e.update(rows=R, work=f"one layer's {r['calls']} call(s) at {R} rows")
            if "library_rows" in r:
                e["library_rows"] = r["library_rows"]
            out.append(e)
        return out

    full = flash_t["decode_fwd_full"]
    flash_entries = [
        dict(entry("flash_fwd", flash_t["flash_fwd"], flash_worst["flash_fwd"]["max_abs_err"]),
             library="scaled_dot_product_attention(is_causal=True, enable_gqa=True)"),
        dict(entry("decode_fwd", flash_t["decode_fwd_served"],
                   flash_worst["decode_fwd"]["max_abs_err"]),
             library="scaled_dot_product_attention(attn_mask=key mask, enable_gqa=True)",
             full_window=dict(ms=full["ms"], plain_ms=full["plain_ms"],
                              bound_ms=full["bound"][0], library_ms=full["library_ms"],
                              eager_ms=full["eager_ms"])),
    ]
    print(json.dumps({"kernels_prefill": entries(PREFILL_ROWS)}))
    print("[profile] decode step, flash_scan vs dense (two runs each, in turns): "
          + json.dumps({impl: {key: [p[key] for p in ps] for key in (
              "step_ms", "device_ms_per_step", "device_idle_share", "cuda_launches_per_step")}
              for impl, ps in profs.items()}))
    print(f"[done] {calls} model calls on the serve path; "
          f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": entries(DECODE_ROWS) + flash_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
