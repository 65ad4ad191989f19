#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure (run in the order 1-7,
9-12, 8):

1. environment: the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, the TF32 flags (both left False);
2. build: compile both kernel libraries from this checkout with nvcc, in
   parallel (``csrc/switchback.cu``, ``csrc/flash_attention.cu``);
3. kernels vs plain: each SwitchBack kernel bit-equal to its plain PyTorch
   version at the serve path's shapes (decode rows 8, prefill rows 1024,
   K in {960, 2560}, M in {320, 960, 2560}, exact half-way ties and an
   all-zero row); each flash forward kernel within a stated tolerance of
   its plain version (one full softmax where the kernel takes an online
   one) in bf16 and f32: prefill at 8 slots, Sq in {32, 64, 96, 128},
   causal and full, and Sk > Sq with kv_valid < Sk; decode at S_max in
   {96, 256} with slot lengths 1, 2, 127, 128, 129, 200 and S_max in one
   batch. At the training path's shapes: the int8 dgrad pair
   (``fused_switchback_dgrad``, ``int8_matmul_dequant_t``) bit-equal at
   2048, 8 and 1000 rows over every linear's widths; ``flash_bwd_dq`` /
   ``flash_bwd_dkv`` within a stated tolerance of ``ref.mha_bwd`` at 8
   sequences of 64, 200 and 256 tokens, causal and full, kv_valid < Sk,
   bf16 and f32; each of the four run twice must give the same bits. A
   control fault (KV head h % KV instead of h // group) must read at
   least 10x outside each flash tolerance;
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
   forward kernels) bit-equal, with ``flash_scan`` within a stated
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
   PyTorch library call, with CUDA events at the path's shapes (the
   serve kernels at decode and prefill rows, the train kernels at 8 x 256
   tokens), beside the least time the card could take (bytes over 3.35
   TB/s, operations over the peak for their type);
9. train (the training path): full-width smollm-360m with
   ``int8_switchback``, ``flash_scan`` and StableAdamW through
   ``make_train_setup``, ``make_train_step`` and ``Trainer``, on BigramLM
   batches of 8 x 256: a warm-up step, then 6 timed steps with every
   launch counter zeroed just before and read just after, each exactly
   its per-layer count times the layers times the steps; every loss
   finite;
10. one train step, kernels vs plain: loss and every gradient at 2 layers
    (full width, three seeds) under flash_scan in f32 and bf16 and under
    dense in f32, and at 32 layers under flash_scan in bf16, within stated tolerances,
    with a control fault outside (KV heads tiled; under dense the weight
    gradient rounded through bf16);
11. card vs CPU: 3 train steps at full width and 2 layers from the same
    parameters and batches (three seeds): loss trajectory and the final
    parameters' per-leaf mean difference within stated tolerances, the control fault (KV heads tiled) outside;
12. train-step profile: wall time, device time and idle share, CUDA
    launches and device time by kernel (torch.profiler), tokens trained
    per second.

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
          "fused_switchback_dgrad": SB_SOURCE, "int8_matmul_dequant_t": SB_SOURCE,
          "flash_fwd": FA_SOURCE, "decode_fwd": FA_SOURCE,
          "flash_bwd_dq": FA_SOURCE, "flash_bwd_dkv": FA_SOURCE}
REPLACES = {
    "tensor_quantize": "src/repro/kernels/switchback/switchback.py:124",
    "fused_switchback_fwd": "src/repro/kernels/switchback/switchback.py:269",
    "row_quantize": "src/repro/kernels/switchback/switchback.py:44",
    "int8_matmul_dequant": "src/repro/kernels/switchback/switchback.py:197",
    "fused_switchback_dgrad": "src/repro/kernels/switchback/switchback.py:315",
    "int8_matmul_dequant_t": "src/repro/kernels/switchback/switchback.py:197",
    "flash_fwd": "src/repro/kernels/flash_attention/flash_attention.py:123",
    "decode_fwd": "src/repro/kernels/flash_attention/flash_attention.py:384",
    "flash_bwd_dq": "src/repro/kernels/flash_attention/flash_attention.py:216",
    "flash_bwd_dkv": "src/repro/kernels/flash_attention/flash_attention.py:302",
}
# the SwitchBack wrappers, forward and input gradient (kernels/switchback/ops.py)
SB_KERNELS = ("tensor_quantize", "fused_switchback_fwd", "row_quantize",
              "int8_matmul_dequant", "fused_switchback_dgrad", "int8_matmul_dequant_t")
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

# the training path: BigramLM batches of 8 x 256 tokens, one microbatch
TRAIN_BATCH, TRAIN_SEQ = 8, 256
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ
# the data chain's vocabulary: BigramLM keeps a dense (V, V) float64
# transition table, 19 GB at the model's 49,152 ids; the chain spans the
# first 8,192 ids (512 MB), the model and its head keep all 49,152
DATA_VOCAB = 8192
# wrapper launches per layer of one train step (forward and backward,
# remat "none"): every linear quantizes its weight once; the forward as
# serving; the dgrad of wq, wk, wv, wo and w_down contracts over the
# layer's output width (960 or 320 <= 2048: fused), that of w_up and
# w_gate over 2560 (row_quantize + the transposed matmul); attention runs
# flash_fwd once and each backward kernel once
TRAIN_PER_LAYER = {"tensor_quantize": 7, "fused_switchback_fwd": 6, "row_quantize": 3,
                   "int8_matmul_dequant": 1, "int8_matmul_dequant_t": 2,
                   "fused_switchback_dgrad": 5, "flash_fwd": 1, "flash_bwd_dq": 1,
                   "flash_bwd_dkv": 1, "decode_fwd": 0}
# flash backward kernel vs plain, relative to max|grad|: the same
# recomputed p on both sides, the sums over keys and query rows in another
# order (f32 in both dtypes: bf16 inputs are exact in f32)
FLASH_BWD_TOL = {"bfloat16": 1e-4, "float32": 1e-4}


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


def plain_flash_bwd(M, which):
    """The plain backward behind the wrapper's signature."""
    fn = getattr(M.FREF, which)

    def bwd(q, k, v, do, lse, di, *, causal, kv_valid=None):
        return fn(q, k, v, do, lse, di, causal=causal,
                  kv_valid=k.shape[1] if kv_valid is None else kv_valid,
                  scale=M.FA.softmax_scale(q.shape[-1]))
    return bwd


def plain_ops(M, flash: bool):
    """Send the model's kernel calls to their plain versions, for the
    whole-model kernels-vs-plain checks only (the package has no such
    switch: its wrappers launch the kernel on a CUDA tensor or raise): the
    six SwitchBack kernels, and with ``flash`` the four flash kernels."""
    patches = [(M.KOPS, name, getattr(M.REF, name)) for name in SB_KERNELS]
    if flash:
        patches += [(M.FA, "flash_fwd_lse", plain_flash_fwd(M)),
                    (M.FA, "decode_attention", plain_decode(M)),
                    (M.FA, "flash_bwd_dq", plain_flash_bwd(M, "flash_bwd_dq")),
                    (M.FA, "flash_bwd_dkv", plain_flash_bwd(M, "flash_bwd_dkv"))]
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
# phases 3b-3c: the training path's kernels against their plain versions
# ---------------------------------------------------------------------------

def compare_train_kernels(torch, M, cfg, dev, seed):
    """The int8 dgrad pair, bitwise against its plain versions at the train
    path's shapes: 2048 rows and the ragged 8 and 1000, g (R, M) against
    the forward's w_q (N, M) for every linear's (M, N) (fused below 2048,
    row_quantize + the transposed matmul for w_up and w_gate's M = 2560),
    bf16 and f32, exact half-way ties and an all-zero row; each kernel run
    twice on the same inputs must give the same bits. Returns the largest
    |kernel - plain| per kernel and the number of comparisons."""
    KOPS, REF = M.KOPS, M.REF
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    worst = {"fused_switchback_dgrad": 0.0, "int8_matmul_dequant_t": 0.0, "row_quantize": 0.0}
    n = 0

    def same(name, fn, ref, what):
        nonlocal n
        got, again = fn(), fn()
        d = max_abs_diff(torch, got, ref)
        worst[name] = max(worst[name], d)
        check(got.dtype == ref.dtype and got.shape == ref.shape and torch.equal(got, ref),
              f"{name} {what}: kernel != plain (max |diff| {d:g})")
        check(torch.equal(got, again), f"{name} {what}: two launches differ")
        n += 1

    D, FF = cfg.d_model, cfg.d_ff
    KVd = cfg.n_kv_heads * cfg.hd
    # (name, (M, N)): the dgrad contracts over the layer's output width M
    fused = {"wq": (D, D), "wk": (KVd, D), "wo": (D, D), "w_down": (D, FF)}
    for R in (TRAIN_ROWS, 8, 1000):
        for dt in (torch.bfloat16, torch.float32):
            for lin, (Mw, N) in fused.items():
                w_q, s_w = KOPS.tensor_quantize(weight(torch, gen, N, Mw, dev, ties=R == 8))
                g = activations(torch, gen, R, Mw, dev, dt)
                same("fused_switchback_dgrad", lambda: KOPS.fused_switchback_dgrad(g, w_q, s_w),
                     REF.fused_switchback_dgrad(g, w_q, s_w), f"{lin} R={R} {dt}")
            w_q, s_w = KOPS.tensor_quantize(weight(torch, gen, D, FF, dev))     # w_up (D, FF)
            g = activations(torch, gen, R, FF, dev, dt)
            g_q, s_g = KOPS.row_quantize(g)
            rq, rs = REF.row_quantize(g)
            same("row_quantize", lambda: KOPS.row_quantize(g)[0], rq, f"dgrad R={R} {dt}")
            same("row_quantize", lambda: KOPS.row_quantize(g)[1], rs, f"dgrad state R={R} {dt}")
            scale = s_g * REF.div(s_w, 127.0 * 127.0)
            same("int8_matmul_dequant_t",
                 lambda: KOPS.int8_matmul_dequant_t(g_q, w_q, scale, out_dtype=dt),
                 REF.int8_matmul_dequant_t(g_q, w_q, scale, out_dtype=dt), f"w_up R={R} {dt}")
    torch.cuda.synchronize()
    return worst, n


def kv_grads_by_modulo(dk_heads, n_kv):
    """The control fault's dk/dv: a gradient over H query heads' own K/V
    copies (B, S, H, hd) summed onto KV head h % KV (the tiled wiring)."""
    B, S, H, hd = dk_heads.shape
    return dk_heads.reshape(B, S, H // n_kv, n_kv, hd).sum(dim=2)


def compare_flash_bwd(torch, M, cfg, dev, seed):
    """flash_bwd_dq / flash_bwd_dkv against the plain ``ref.mha_bwd`` on the
    same (q, k, v, do) and the kernel forward's o and lse, bf16 and f32, 8
    sequences of 64, 200 and 256 tokens, causal and full, and kv_valid <
    Sk; within FLASH_BWD_TOL of max|grad|. Each kernel run twice must give
    the same bits, and the control fault (the plain backward with KV head
    h % KV) must read FAULT_MARGIN x outside the tolerance."""
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scale = M.FA.softmax_scale(hd)
    out = {k: dict(max_abs_err=0.0, max_rel_err=0.0, fault_over_tol=math.inf)
           for k in ("flash_bwd_dq", "flash_bwd_dkv")}
    n = 0

    def rand(*shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    cases = [(S, S, c) for S in (64, 200, TRAIN_SEQ) for c in (True, False)]
    cases += [(TRAIN_SEQ, 200, c) for c in (True, False)]
    for dt in (torch.bfloat16, torch.float32):
        tol = FLASH_BWD_TOL[str(dt).replace("torch.", "")]
        for S, kv_valid, causal in cases:
            B = TRAIN_BATCH
            q, do = rand(B, S, H, hd, dt=dt), rand(B, S, H, hd, dt=dt)
            k, v = rand(B, S, KV, hd, dt=dt), rand(B, S, KV, hd, dt=dt)
            kw = dict(causal=causal, kv_valid=kv_valid)
            o, lse = M.FA.flash_fwd_lse(q, k, v, **kw)
            di = M.FREF.attention_di(o, do)
            dq = M.FA.flash_bwd_dq(q, k, v, do, lse, di, **kw)
            dk, dv = M.FA.flash_bwd_dkv(q, k, v, do, lse, di, **kw)
            check(torch.equal(dq, M.FA.flash_bwd_dq(q, k, v, do, lse, di, **kw)),
                  f"flash_bwd_dq S{S} {dt}: two launches differ")
            check(all(torch.equal(a, b) for a, b in
                      zip((dk, dv), M.FA.flash_bwd_dkv(q, k, v, do, lse, di, **kw))),
                  f"flash_bwd_dkv S{S} {dt}: two launches differ")
            rdq, rdk, rdv = M.FREF.mha_bwd(q, k, v, o, lse, do, scale=scale, **kw)
            fdq, fdk, fdv = M.FREF.mha_bwd(q, kv_heads_by_modulo(k, H),
                                           kv_heads_by_modulo(v, H), o, lse, do,
                                           scale=scale, **kw)
            fdk, fdv = kv_grads_by_modulo(fdk, KV), kv_grads_by_modulo(fdv, KV)
            what = f"B{B} S{S} kv_valid{kv_valid} causal={causal} {dt}"
            for name, pairs in (("flash_bwd_dq", ((dq, rdq, fdq),)),
                                ("flash_bwd_dkv", ((dk, rdk, fdk), (dv, rdv, fdv)))):
                r = out[name]
                for got, want, fault in pairs:
                    check(got.dtype == torch.float32 and got.shape == want.shape
                          and bool(torch.isfinite(got).all()), f"{name} {what}: bad output")
                    err = rel_err(torch, got, want)
                    r["max_rel_err"] = max(r["max_rel_err"], err)
                    r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(torch, got, want))
                    check(err <= tol, f"{name} {what}: kernel vs plain {err:g} > {tol:g}")
                    f = rel_err(torch, got, fault) / tol
                    r["fault_over_tol"] = min(r["fault_over_tol"], f)
                    check(f >= FAULT_MARGIN, f"{name} {what}: the control fault reads only "
                          f"{f:g} x the tolerance")
                    n += 1
            check(float(dk[:, kv_valid:].abs().sum()) == 0.0 == float(dv[:, kv_valid:].abs().sum()),
                  f"flash_bwd_dkv {what}: keys past kv_valid got a gradient")
    torch.cuda.synchronize()
    return out, n


# ---------------------------------------------------------------------------
# phases 9-12: the training path
# ---------------------------------------------------------------------------

def train_parts(torch, cfg, dev, *, compute_dtype=None, impl="flash_scan", steps=100):
    """(bundle, policy, parallel, TrainConfig, train_step, opt, scaler) of
    the path: int8_switchback, StableAdamW (warm-up 4, cosine over
    ``steps``), no loss scaling, remat "none"."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.precision import QuantPolicy
    from repro_torch.models import build
    from repro_torch.train import make_train_setup, make_train_step
    bundle = build(cfg)
    policy = QuantPolicy("int8_switchback", compute_dtype=compute_dtype or torch.bfloat16)
    parallel = ParallelConfig(remat="none", attn_impl=impl)
    tc = TrainConfig(learning_rate=2e-3, warmup_steps=4, total_steps=steps,
                     quant_mode="int8_switchback")
    opt, scaler = make_train_setup(tc)
    step = make_train_step(bundle, policy, parallel, tc, opt, scaler)
    return bundle, policy, parallel, tc, step, opt, scaler


def bigram_batches(torch, n, batch, seq, dev, seed):
    """``n`` BigramLM batches (the data chain over DATA_VOCAB ids), on ``dev``."""
    from repro_torch.data import BigramLM
    data = BigramLM(DATA_VOCAB, seed=seed, temperature=0.2)
    return [{k: torch.from_numpy(v).to(device=dev, dtype=torch.long)
             for k, v in data.batch(batch, seq).items()} for _ in range(n)]


def train(torch, M, cfg, dev, seed, timed_steps=6):
    """Full-width training through ``Trainer``: a warm-up step, then
    ``timed_steps`` steps with every launch counter zeroed just before and
    read just after; each must be exactly its per-layer count x the layers
    x the steps, and every loss finite."""
    from repro_torch.models import params as PRM
    from repro_torch.train import Trainer, init_train_state
    bundle, policy, parallel, tc, step, opt, scaler = train_parts(torch, cfg, dev)
    t = time.perf_counter()
    params = PRM.init_params(bundle.param_specs, seed, device=dev)
    state = init_train_state(params, opt, scaler)
    batches = bigram_batches(torch, 1 + timed_steps, TRAIN_BATCH, TRAIN_SEQ, dev, seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"[train] {cfg.n_layers} layers, {n_params / 1e6:.1f} M params, "
          f"{len(batches)} BigramLM batches of {TRAIN_BATCH} x {TRAIN_SEQ} on {dev} "
          f"in {time.perf_counter() - t:.1f} s")
    trainer = Trainer(step, state, log_every=1000)
    trainer.run(lambda i: batches[i], 1)                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(M)
    t = time.perf_counter()
    trainer.run(lambda i: batches[i], timed_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = launch_counts(M)
    losses = [h["loss"] for h in trainer.history]
    check(len(losses) == 1 + timed_steps and all(math.isfinite(x) for x in losses),
          f"non-finite or missing losses: {losses}")
    for k, per in TRAIN_PER_LAYER.items():
        want = per * cfg.n_layers * timed_steps
        check(per == 0 or counts[k] > 0, f"{k} never launched on the train path")
        check(counts[k] == want, f"{k}: {counts[k]} launches in {timed_steps} train steps, "
              f"expected {want} ({per} per layer x {cfg.n_layers} layers x {timed_steps})")
    res = dict(step_ms=wall / timed_steps * 1e3,
               tokens_per_s=timed_steps * TRAIN_ROWS / wall, losses=losses,
               grad_norms=[h["grad_norm"] for h in trainer.history],
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches_per_step={k: v / timed_steps for k, v in counts.items()},
               stability=trainer.stability_report())
    print("[train]", json.dumps(res))
    return trainer, batches, counts, res


def grad_errs(torch, got, want):
    """(loss relative error, worst per-leaf max |diff| / max|want|, worst
    per-leaf mean |diff| / max|want|, the leaf of that mean) between two
    (loss, grads) pairs."""
    (gg, gl), (wg, wl) = got[:2], want[:2]
    loss = abs(float(gl) - float(wl)) / abs(float(wl))
    return (loss, *tree_errs(gg, wg))


def tree_errs(got, want):
    """Worst per-leaf (max, mean) |got - want| over the leaf's max|want|,
    and the path of the leaf with the worst mean."""
    from repro_torch.models.params import tree_paths
    mx = mean = 0.0
    worst = ""
    for (path, a), b in zip(tree_paths(got), (leaf for _, leaf in tree_paths(want))):
        a, b = a.double(), b.double()
        top = float(b.abs().max()) or 1.0
        mx = max(mx, float((a - b).abs().max()) / top)
        m = float((a - b).abs().mean()) / top
        if m >= mean:
            mean, worst = m, path
    return mx, mean, worst


# the 2-layer comparisons of phases 10 and 11 run from this many seeds
CHECK_SEEDS = 3


def check_seeds(seed, offset):
    return [seed + offset + 100 * j for j in range(CHECK_SEEDS)]


# one train step's loss and gradients, kernels against plain versions:
# (loss relative, per-leaf max and mean |diff| relative to the leaf's max).
# Under flash_scan the flash kernels sum in another order than the plain
# versions; the int8 quantizers turn a last-bit difference in an activation
# into one quantization step of its row now and then, more often in f32
# (see SERVED_FLASH_TOL). Under dense attention every kernel on the path
# is bit-equal to its plain version, so only the order of the embedding's
# scatter-add could differ. Each flash_scan limit is the geometric mean of
# the worst sound reading and the smallest control-fault reading over
# three seeds on an H100, rounded to one digit (readings in PERF.md,
# Findings): sound up to 2.1e-5 / 3.7e-2 / 4.4e-3, the fault at
# least 1.4e-3 / 1.5 / 2.4e-1. Under dense every sound reading was 0.
STEP_TOL = {"flash_scan": {"float32": (2e-4, 2e-1, 3e-2), "bfloat16": (2e-4, 2e-1, 3e-2)},
            "dense": {"float32": (1e-6, 1e-5, 1e-6)}}


def whole_step(torch, M, cfg, dev, seed, params32, batch):
    """One train step's loss and gradients with the kernels and with their
    plain versions swapped in: at 2 layers (full width) under flash_scan
    in f32 and bf16 and under dense in f32, from CHECK_SEEDS seeds of
    parameters and batches, and at full depth under flash_scan in bf16
    (the trained parameters). Each within STEP_TOL; the control faults
    must land outside: the KV heads tiled under flash_scan, and under dense
    in f32 the weight gradient rounded through bf16 (what a cast before the
    autograd function would do). Every reading is printed before any is
    checked."""
    from repro_torch.core import switchback as SB
    from repro_torch.models import params as PRM
    from repro_torch.train import loss_and_grads
    small = dataclasses.replace(cfg, n_layers=2)
    cases = []
    for s in check_seeds(seed, 3):
        p_small = PRM.init_params(param_specs_of(small), s, device=dev)
        b_small = bigram_batches(torch, 1, TRAIN_BATCH, TRAIN_SEQ, dev, s)[0]
        cases += [(f"2L_flash_scan_float32_seed{s}", small, p_small, b_small, "flash_scan",
                   torch.float32),
                  (f"2L_flash_scan_bfloat16_seed{s}", small, p_small, b_small, "flash_scan",
                   torch.bfloat16),
                  (f"2L_dense_float32_seed{s}", small, p_small, b_small, "dense", torch.float32)]
    cases.append((f"{cfg.n_layers}L_flash_scan_bfloat16", cfg, params32, batch, "flash_scan",
                  torch.bfloat16))
    orig_wgrad = SB.wgrad_16bit
    res, finite = {}, {}
    for name, c, params, b, impl, cd in cases:
        bundle, policy, parallel, *_ = train_parts(torch, c, dev, compute_dtype=cd, impl=impl)
        run = lambda: loss_and_grads(bundle, policy, parallel, params, b)
        kern = run()
        with plain_ops(M, flash=impl != "dense"):
            plain = run()
            if impl == "dense":
                fault_patch = [(SB, "wgrad_16bit",
                                lambda x, g: orig_wgrad(x, g).to(torch.bfloat16).float())]
            else:
                fault_patch = [(M.FREF, "_expand_heads", kv_heads_by_modulo)]
            with swapped(fault_patch):
                fault = run()
        errs = grad_errs(torch, kern, plain)
        f_errs = grad_errs(torch, fault, plain)
        res[name] = dict(loss=float(kern[1]), loss_plain=float(plain[1]),
                         loss_rel_err=errs[0], grad_max_rel_err=errs[1],
                         grad_mean_rel_err=errs[2], worst_mean_leaf=errs[3],
                         tolerance=STEP_TOL[impl][str(cd).replace("torch.", "")],
                         fault=("dw rounded through bf16" if impl == "dense"
                                else "KV head h % KV"),
                         fault_loss_rel_err=f_errs[0], fault_grad_max_rel_err=f_errs[1],
                         fault_grad_mean_rel_err=f_errs[2])
        finite[name] = math.isfinite(float(kern[1])) and all(
            bool(torch.isfinite(g).all()) for g in PRM.tree_leaves(kern[0]))
        del kern, plain, fault
    print("[whole step]", json.dumps(res))
    for name, r in res.items():
        tol = r["tolerance"]
        errs = (r["loss_rel_err"], r["grad_max_rel_err"], r["grad_mean_rel_err"])
        f_errs = (r["fault_loss_rel_err"], r["fault_grad_max_rel_err"],
                  r["fault_grad_mean_rel_err"])
        check(finite[name], f"whole step {name}: non-finite loss or gradient")
        check(all(e <= t for e, t in zip(errs, tol)),
              f"whole step {name}: kernels vs plain {errs} > {tol}")
        check(any(e > t for e, t in zip(f_errs, tol)),
              f"whole step {name}: the control fault ({f_errs}) lies within {tol}, "
              "which so could not see it")
    return res


def param_specs_of(cfg):
    from repro_torch.models import build
    return build(cfg).param_specs


# card against CPU, 3 steps at full width and 2 layers: (loss relative per
# step, final parameters' worst per-leaf mean |diff| relative to the
# leaf's max). The card runs the kernels, the CPU their plain versions
# (which the CPU tests hold against the JAX package); they differ in the
# order of f32 sums (GEMMs, softmax), which the int8 quantizers and Adam's
# normalised step carry into the parameters. The parameters' per-leaf max
# is printed but not bounded: an element whose gradient is near 0 moves by
# about +-lr either way, so the max is a few lr whatever the cause (sound
# 2.0e-2, the control fault 2.8e-2 on an H100). Each limit is the
# geometric mean of the worst sound reading and the smallest reading of
# the control fault (KV heads tiled) over three seeds on an H100, rounded
# to one digit: loss 1.1e-4 against 1.3e-3, mean 1.8e-4 against 9.3e-3
# (readings in PERF.md, Findings).
CARD_CPU_TOL = {"loss_rel_err": 4e-4, "param_mean_rel_err": 1e-3}


def card_vs_cpu(torch, M, cfg, dev, seed, steps=3):
    """The same 3 train steps at full width and 2 layers on the card and on
    the CPU from the same parameters and batches, from CHECK_SEEDS seeds;
    the control fault (KV heads tiled) on the CPU must land outside the
    tolerance on each. Every reading is printed before any is checked."""
    from repro_torch.models import params as PRM
    from repro_torch.train import init_train_state
    small = dataclasses.replace(cfg, n_layers=2)

    def run(where, p_cpu, batches_cpu, fault=False):
        bundle, policy, parallel, tc, step, opt, scaler = train_parts(torch, small, where)
        params = PRM.tree_map(lambda t: t.clone().to(where), p_cpu)
        state = init_train_state(params, opt, scaler)
        losses = []
        with (tiled_kv_heads(M) if fault else contextlib.nullcontext()):
            for b in batches_cpu:
                state, m = step(state, {k: v.to(where) for k, v in b.items()})
                losses.append(float(m["loss"]))
        return losses, PRM.tree_map(lambda t: t.cpu(), state.params)

    def errs(a, b):
        mx, mean, leaf = tree_errs(a[1], b[1])
        return dict(loss_rel_err=max(abs(x - y) / abs(y) for x, y in zip(a[0], b[0])),
                    param_max_rel_err=mx, param_mean_rel_err=mean, worst_mean_leaf=leaf)

    res = {}
    for s in check_seeds(seed, 5):
        p_cpu = PRM.init_params(param_specs_of(small), s, device="cpu")
        batches_cpu = bigram_batches(torch, steps, 4, 64, "cpu", s)
        card, cpu = run(dev, p_cpu, batches_cpu), run("cpu", p_cpu, batches_cpu)
        fault = run("cpu", p_cpu, batches_cpu, fault=True)
        res[f"seed{s}"] = dict(losses_card=card[0], losses_cpu=cpu[0], losses_fault=fault[0],
                               **errs(card, cpu), fault="KV heads tiled (CPU)",
                               **{"fault_" + k: v for k, v in errs(fault, cpu).items()})
    print("[card vs cpu]", json.dumps(dict(tolerance=CARD_CPU_TOL, **res)))
    for name, r in res.items():
        check(all(math.isfinite(x) for x in r["losses_card"]),
              f"card vs CPU {name}: non-finite loss on the card")
        check(all(r[k] <= t for k, t in CARD_CPU_TOL.items()),
              f"card vs CPU {name}: {r} outside {CARD_CPU_TOL}")
        check(all(r["fault_" + k] > t for k, t in CARD_CPU_TOL.items()),
              f"card vs CPU {name}: the control fault lies within {CARD_CPU_TOL}: {r}")
    return res


TRAIN_KERNEL_GROUPS = (
    ("fused_fwd_kernel", "true>", "fused_switchback_dgrad"),
    ("fused_fwd_kernel", "", "fused_switchback_fwd"),
    ("int8_matmul_dequant_kernel", "true>", "int8_matmul_dequant_t"),
    ("int8_matmul_dequant_kernel", "", "int8_matmul_dequant"),
    ("row_quantize", "", "row_quantize"),
    ("absmax_partial", "", "tensor_quantize"),
    ("cast_tensorwise", "", "tensor_quantize"),
    ("flash_bwd_dq", "", "flash_bwd_dq"),
    ("flash_bwd_dkv", "", "flash_bwd_dkv"),
    ("flash_fwd", "", "flash_fwd"),
)


# PyTorch's own kernels on the train step, by family (lower-case patterns)
TORCH_KERNEL_GROUPS = (
    (("gemm", "nvjet", "xmma", "cutlass", "cublas"), "gemm (wgrad, lm head)"),
    (("reduce_kernel",), "torch reductions (norms, loss, optimizer means, health)"),
    (("index",), "torch gather/scatter (embedding, loss)"),
    (("elementwise", "copy"), "torch elementwise (casts, norms, RoPE, optimizer)"),
)


def train_profile(torch, M, trainer, batches, n_steps=3):
    """One train step's wall time (over ``n_steps``, ending in a
    synchronize), then its device time, CUDA launches and the device time
    by kernel family from torch.profiler over another ``n_steps``."""
    from torch.profiler import ProfilerActivity, profile
    start = int(trainer.state.step)
    data = lambda i: batches[(i - start) % len(batches)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.run(data, n_steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / n_steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run(data, n_steps)
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us and getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type):
            by_kernel[e.key] = (us / n_steps / 1e3, e.count / n_steps)
    dev_ms = sum(v[0] for v in by_kernel.values())
    groups = {}
    for key, (ms, cnt) in by_kernel.items():
        g = next((name for pat, flag, name in TRAIN_KERNEL_GROUPS
                  if pat in key and flag in key), None)
        if g is None:
            low = key.lower()
            g = next((name for pats, name in TORCH_KERNEL_GROUPS
                      if any(pat in low for pat in pats)), "other")
        a = groups.setdefault(g, [0.0, 0])
        a[0] += ms
        a[1] += cnt
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    res = dict(step_ms=step_ms, tokens_per_s=TRAIN_ROWS / step_ms * 1e3,
               device_ms_per_step=dev_ms,
               cuda_launches_per_step=sum(v[1] for v in by_kernel.values()),
               device_idle_share=(max(0.0, 1 - dev_ms / step_ms) if dev_ms else None),
               groups={g: {"ms": v[0], "launches": v[1]} for g, v in
                       sorted(groups.items(), key=lambda kv: -kv[1][0])},
               top=[{"kernel": k[:90], "ms": v[0], "launches": v[1]} for k, v in top])
    if not dev_ms:
        print("[train profile] torch.profiler saw no device time; step wall time only")
    print("[train profile]", json.dumps(res))
    return res


def time_train_kernels(torch, M, cfg, dev, seed):
    """The training path's new kernels at its shapes, one layer's calls:
    the int8 dgrad pair at 2048 rows (5 fused calls, 2 transposed), the
    flash backward pair at 8 x 256 causal bf16 (one call each); each with
    its plain version, a library call where one exists and the bound."""
    import torch.nn.functional as F
    KOPS, REF = M.KOPS, M.REF
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    R = TRAIN_ROWS
    D, FF = cfg.d_model, cfg.d_ff
    KVd = cfg.n_kv_heads * cfg.hd
    fused = [(D, D), (KVd, D), (KVd, D), (D, D), (D, FF)]     # (M, N): wq wk wv wo w_down
    two = [(FF, D), (FF, D)]                                  # w_up, w_gate

    def one_set():
        s = {"fused": [], "two": []}
        for Mw, N in fused:
            w_q, s_w = KOPS.tensor_quantize(weight(torch, gen, N, Mw, dev))
            s["fused"].append((activations(torch, gen, R, Mw, dev), w_q, s_w))
        for Mw, N in two:
            w_q, s_w = KOPS.tensor_quantize(weight(torch, gen, N, Mw, dev))
            g_q, s_g = KOPS.row_quantize(activations(torch, gen, R, Mw, dev))
            s["two"].append((g_q, w_q, s_g * REF.div(s_w, 127.0 * 127.0)))
        return s

    per_set = sum(R * m * 2 + m * n for m, n in fused) + sum(R * m + m * n for m, n in two)
    sets = [one_set() for _ in range(max(2, int(120e6 // per_set) + 1))]
    torch.cuda.synchronize()

    def int_mm(g_q, w_q, scale):
        return (torch._int_mm(g_q, w_q.t()).float() * scale).to(torch.bfloat16)

    g_q, w_q, sc = sets[0]["two"][0]
    check(torch.equal(int_mm(g_q, w_q, sc), KOPS.int8_matmul_dequant_t(g_q, w_q, sc)),
          "torch._int_mm yardstick disagrees with int8_matmul_dequant_t")
    out = {}
    nset = len(sets)
    # name: (calls, call(set, ops module), library call, bytes, int8 ops, f32 ops)
    work = {
        "fused_switchback_dgrad": (
            len(fused), lambda s, op: [op.fused_switchback_dgrad(*a) for a in s["fused"]], None,
            sum(R * m * 2 + m * n + 4 + R * n * 2 for m, n in fused),
            sum(2 * R * m * n for m, n in fused), sum(4 * R * m for m, _ in fused)),
        "int8_matmul_dequant_t": (
            len(two), lambda s, op: [op.int8_matmul_dequant_t(*a) for a in s["two"]],
            lambda s: [int_mm(*a) for a in s["two"]],
            sum(R * m + m * n + R * 4 + R * n * 2 for m, n in two),
            sum(2 * R * m * n for m, n in two), 0),
    }
    for name, (calls, call, library, bytes_, i8, f32) in work.items():
        out[name] = dict(
            ms=graph_ms(torch, lambda i: call(sets[i], KOPS), nset),
            plain_ms=graph_ms(torch, lambda i: call(sets[i], REF), nset),
            library_ms=graph_ms(torch, lambda i: library(sets[i]), nset) if library else None,
            eager_ms=eager_ms(torch, lambda i: call(sets[i], KOPS), nset),
            bound=bound(bytes_, int8_ops=i8, f32_ops=f32), calls=calls,
            work=f"one layer's {calls} call(s) at {R} rows")
    del sets

    # the flash backward pair at one layer's shape: 8 x 256, causal, bf16
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B, S = TRAIN_BATCH, TRAIN_SEQ
    bf = torch.bfloat16

    def attn_set():
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(bf) for shape in
                       ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd)))
        o, lse = M.FA.flash_fwd_lse(q, k, v, causal=True)
        return q, k, v, do, lse, M.FREF.attention_di(o, do)

    per = (2 * B * S * H * hd + 2 * B * S * KV * hd) * 2 + 2 * B * H * S * 4
    asets = [attn_set() for _ in range(max(2, int(120e6 // per) + 1))]
    pairs = B * H * S * (S + 1) // 2                          # causal live pairs
    plain = {k: plain_flash_bwd(M, k) for k in ("flash_bwd_dq", "flash_bwd_dkv")}

    # the library yardstick: SDPA's backward (dq, dk, dv together), eager
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in asets[0][:3])
    o_s = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    do_s = asets[0][3].transpose(1, 2)
    sdpa_dq = torch.autograd.grad(o_s, qs, do_s, retain_graph=True)[0].transpose(1, 2)
    dq0 = M.FA.flash_bwd_dq(*asets[0], causal=True)
    sdpa_err = rel_err(torch, sdpa_dq.float(), dq0)
    check(sdpa_err <= 2e-2, f"SDPA backward yardstick disagrees with flash_bwd_dq ({sdpa_err:g})")
    sdpa_bwd_ms = eager_ms(torch, lambda i: torch.autograd.grad(
        o_s, (qs, ks, vs), do_s, retain_graph=True), 1)
    dkv_bytes = per + 2 * B * S * KV * hd * 4
    dq_bytes = per + B * S * H * hd * 4
    for name, bytes_, flops in (("flash_bwd_dq", dq_bytes, 6.0 * pairs * hd),
                                ("flash_bwd_dkv", dkv_bytes, 8.0 * pairs * hd)):
        fn = getattr(M.FA, name)
        out[name] = dict(
            ms=graph_ms(torch, lambda i: fn(*asets[i], causal=True), len(asets)),
            plain_ms=graph_ms(torch, lambda i: plain[name](*asets[i], causal=True), len(asets)),
            library_ms=sdpa_bwd_ms, library="SDPA backward (dq, dk, dv together), eager",
            sdpa_rel_err=sdpa_err,
            eager_ms=eager_ms(torch, lambda i: fn(*asets[i], causal=True), len(asets)),
            bound=bound(bytes_, bf16_ops=flops), calls=1,
            work=f"one layer's call: {B} x {S} tokens, causal, bf16")
    print("[timing] train kernels:", json.dumps(out))
    return out


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
    dgrad_worst, n_dgrad = compare_train_kernels(torch, M, cfg, dev, args.seed)
    print(f"[kernels] {n_dgrad} dgrad comparisons bit-equal and bit-identical over two "
          "launches; max |kernel - plain| " + json.dumps(dgrad_worst))
    bwd_worst, n_bwd = compare_flash_bwd(torch, M, cfg, dev, args.seed)
    print(f"[kernels] {n_bwd} flash backward comparisons within {json.dumps(FLASH_BWD_TOL)} "
          f"of max|grad|, bit-identical over two launches; control fault >= "
          f"{FAULT_MARGIN:g}x the tolerance: " + json.dumps(bwd_worst))

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

    # 9. train (the training path): full width through Trainer
    trainer, batches, train_counts, train_res = train(torch, M, cfg, dev, args.seed)
    # 10. one train step, kernels vs plain
    whole_step(torch, M, cfg, dev, args.seed, trainer.state.params, batches[0])
    # 11. card vs CPU, 3 steps at full width and 2 layers
    card_vs_cpu(torch, M, cfg, dev, args.seed)
    # 12. train-step profile
    train_prof = train_profile(torch, M, trainer, batches)
    del trainer, batches
    torch.cuda.empty_cache()

    # 8. timing
    rows = {}
    for R in (PREFILL_ROWS, DECODE_ROWS):
        rows[R] = time_kernels(torch, KOPS, REF, cfg, dev, args.seed, R)
    flash_t = time_flash(torch, M, cfg, dev, args.seed, served_lens)
    print("[timing] flash:", json.dumps(flash_t))
    train_t = time_train_kernels(torch, M, cfg, dev, args.seed)
    calls = stats["decode_steps"] + stats["prefill_calls"]
    per_train_step = train_res["launches_per_step"]

    def entry(name, r, err):
        """A serve-path kernel: ``launches`` from the serve run; its train
        launches beside them."""
        b_ms, b_by = r["bound"]
        return dict(name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
                    launches=counts[name],
                    launches_per_decode_step=prof["launches_per_step"][name],
                    launches_train=train_counts[name],
                    launches_per_train_step=per_train_step[name],
                    max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b_ms,
                    bound_by=b_by, library_ms=r["library_ms"], eager_ms=r["eager_ms"],
                    calls_timed=r["calls"], work=r.get("work"))

    def train_entry(name, err):
        """A kernel of the training path only: ``launches`` from the train run."""
        r = train_t[name]
        b_ms, b_by = r["bound"]
        return dict(name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
                    launches=train_counts[name], launches_per_train_step=per_train_step[name],
                    max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b_ms,
                    bound_by=b_by, library_ms=r["library_ms"], eager_ms=r["eager_ms"],
                    calls_timed=r["calls"], work=r["work"],
                    **({"library": r["library"]} if "library" in r else {}))

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
    train_entries = [
        train_entry("fused_switchback_dgrad", dgrad_worst["fused_switchback_dgrad"]),
        train_entry("int8_matmul_dequant_t", dgrad_worst["int8_matmul_dequant_t"]),
        train_entry("flash_bwd_dq", bwd_worst["flash_bwd_dq"]["max_abs_err"]),
        train_entry("flash_bwd_dkv", bwd_worst["flash_bwd_dkv"]["max_abs_err"]),
    ]
    print("[train] step: " + json.dumps({
        "step_ms_trainer": train_res["step_ms"], "tokens_per_s_trainer": train_res["tokens_per_s"],
        **{k: train_prof[k] for k in ("step_ms", "tokens_per_s", "device_ms_per_step",
                                      "device_idle_share", "cuda_launches_per_step")}}))
    print(f"[done] {calls} model calls on the serve path, "
          f"{len(train_res['losses'])} train steps; total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": entries(DECODE_ROWS) + flash_entries + train_entries}))
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
