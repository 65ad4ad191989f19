#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure (run in the order 1-7,
9-17, 19, 20, 8, 18, 23, 21, 22):

1. environment: the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, the TF32 flags (both left False);
2. build: compile the three kernel libraries from this checkout with nvcc,
   in parallel (``csrc/switchback.cu``, ``csrc/flash_attention.cu``,
   ``csrc/fp8_matmul.cu``);
3. kernels vs plain: each SwitchBack kernel bit-equal to its plain PyTorch
   version at the serve path's shapes (decode rows 8, prefill rows 1024,
   K in {960, 2560}, M in {320, 960, 2560}, exact half-way ties and an
   all-zero row); each flash forward kernel within a stated tolerance of
   its plain version (one full softmax where the kernel takes an online
   one) in bf16 and f32: prefill at 8 slots, Sq in {32, 64, 96, 128},
   causal and full, and Sk > Sq with kv_valid < Sk; decode at S_max in
   {96, 256} with slot lengths 1, 2, 127, 128, 129, 200 and S_max in one
   batch. At the training path's shapes (``compare_linear_kernels``,
   ``compare_flash_train``): every SwitchBack kernel of the tensor-wise
   modes, forward and dgrad, bit-equal at 2048, 8 and 1000 rows over
   every linear's widths; ``flash_fwd``, ``flash_bwd_dq`` and
   ``flash_bwd_dkv`` within stated tolerances of their plain versions at
   8 sequences of 64, 200 and 256 tokens, causal and full, kv_valid < Sk,
   bf16 and f32; each run twice must give the same bits. A control fault
   (KV head h % KV instead of h // group) must read at least 10x outside
   each flash tolerance;
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
    per second;
13. CLIP kernels vs plain: every SwitchBack kernel of the four modes
    (the fused forward and dgrad, ``row_quantize`` with
    ``int8_matmul_dequant`` and its transposed form, ``tensor_quantize``,
    ``col_quantize`` and the colscale matmul in both orientations)
    bit-equal to its plain version at the shapes phase 15 gives it (every
    weight of both towers, batch 32: 4,128 vision rows, 8,192 patch rows
    at K = 588, 2,464 text rows), ties and an all-zero row, each run twice
    with the same bits;
14. the flash kernels at CLIP's attention shapes, vision (32, 129, 16, 80)
    with no mask and text (32, 77, 16, 64) causal, forward and both
    backward kernels, bf16 and f32, within the tolerances of phase 3; the
    control faults (lanes past 64 dropped at hd 80, the mask dropped at
    hd 64) at least 10x outside;
15. CLIP train (the paper's own model): full-width ViT-H/14 (0.99 B
    parameters, random weights from a seeded torch.Generator) through
    ``make_train_setup``, ``make_train_step`` and ``Trainer`` in each of
    ``int8_switchback`` (zero-init layer-scale), ``int8_switchback_m``,
    ``int8_switchback_q`` and ``int8_llm``: SyntheticCLIP batches of 32
    pairs at 224 px, patch dropout 0.5, StableAdamW; a warm-up step, then
    3 timed steps with every launch counter zeroed just before and read
    just after, each exactly the count worked out from the layer shapes
    (``clip_launches_per_step``); every loss finite; peak memory; one
    step profiled;
16. one CLIP train step at 2 + 2 layers and full width, kernels vs plain,
    in each int8 mode: under flash_scan from three seeds within stated
    tolerances, the control fault (the positional embedding read one row
    off) outside; under dense bit-equal;
17. CLIP card vs CPU: 3 train steps at 2 + 2 layers and full width from
    three seeds, which take the two column-wise modes in turn, the same
    fault outside;
18. timing of the CLIP kernels: one vision layer's calls at 4,128 rows,
    beside their bound, plain version and ``torch._int_mm`` + scale;
19. fp8 kernels vs plain at every CLIP main-path shape (phase 13's table,
    both formats): ``row_quantize``, ``tensor_quantize``,
    ``block_quantize`` and ``fp8_matmul_dequant`` in both orientations
    bit-equal; ``fp8_mixed_matmul`` in both within MIXED_TOL (stated before
    its first card run), with outlier tiles so that both branches run and
    its control fault (the fallback dropped) outside; fp8 ties, an
    all-zero row and an all-zero tile; each run twice with the same bits;
20. CLIP fp8 train: as phase 15 in ``fp8_sim`` (zero-init layer-scale,
    the paper's recipe), ``fp8``, ``fp8_mixed`` and ``fp8_switchback``;
    every launch counter (the seven fp8 kernel forms included) exactly its
    worked-out count;
21. one CLIP step at 2 + 2 layers and full width, kernels vs plain, in
    ``fp8`` and ``fp8_mixed`` from three seeds (as phase 16): under dense
    bit-equal, under flash_scan within CLIP_FP8_STEP_TOL, the fault
    outside;
22. CLIP fp8 card vs CPU: 3 steps at 2 + 2 layers, ``fp8`` and
    ``fp8_mixed`` in turn across three seeds (as phase 17);
23. timing of the fp8 kernels: one vision layer's calls at 4,128 rows
    beside their bound (the matmuls' operations at the fp8 peak), plain
    version and ``torch._scaled_mm`` with row-wise scales.

Each phase prints its seconds (``[time]``), and all of them together
before the result. The line before the last holds ``{"kernels": [...]}``;
the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (dense): HBM bandwidth, int8, fp8 and bf16
# tensor-core ops, f32 ops outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

SB_SOURCE = "src/repro_torch/kernels/switchback/csrc/switchback.cu"
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
F8_SOURCE = "src/repro_torch/kernels/fp8_matmul/csrc/fp8_matmul.cu"
# the fp8 wrappers' launch-count keys (kernels/fp8_matmul/ops.py)
FP8_KERNELS = ("fp8_row_quantize", "fp8_tensor_quantize", "fp8_block_quantize",
               "fp8_matmul_dequant", "fp8_matmul_dequant_t", "fp8_mixed_matmul",
               "fp8_mixed_matmul_t")
F8_PY = "src/repro/kernels/fp8_matmul/fp8_matmul.py"
SOURCE = {"tensor_quantize": SB_SOURCE, "fused_switchback_fwd": SB_SOURCE,
          "row_quantize": SB_SOURCE, "int8_matmul_dequant": SB_SOURCE,
          "fused_switchback_dgrad": SB_SOURCE, "int8_matmul_dequant_t": SB_SOURCE,
          "col_quantize": SB_SOURCE, "int8_matmul_dequant_colscale": SB_SOURCE,
          "int8_matmul_dequant_colscale_t": SB_SOURCE,
          "flash_fwd": FA_SOURCE, "decode_fwd": FA_SOURCE,
          "flash_bwd_dq": FA_SOURCE, "flash_bwd_dkv": FA_SOURCE,
          **dict.fromkeys(FP8_KERNELS, F8_SOURCE)}
REPLACES = {
    "tensor_quantize": "src/repro/kernels/switchback/switchback.py:124",
    "fused_switchback_fwd": "src/repro/kernels/switchback/switchback.py:269",
    "row_quantize": "src/repro/kernels/switchback/switchback.py:44",
    "int8_matmul_dequant": "src/repro/kernels/switchback/switchback.py:197",
    "fused_switchback_dgrad": "src/repro/kernels/switchback/switchback.py:315",
    "int8_matmul_dequant_t": "src/repro/kernels/switchback/switchback.py:197",
    "col_quantize": "src/repro/kernels/switchback/switchback.py:83",
    "int8_matmul_dequant_colscale": "src/repro/kernels/switchback/switchback.py:176",
    "int8_matmul_dequant_colscale_t": "src/repro/kernels/switchback/switchback.py:176",
    "flash_fwd": "src/repro/kernels/flash_attention/flash_attention.py:123",
    "decode_fwd": "src/repro/kernels/flash_attention/flash_attention.py:384",
    "flash_bwd_dq": "src/repro/kernels/flash_attention/flash_attention.py:216",
    "flash_bwd_dkv": "src/repro/kernels/flash_attention/flash_attention.py:302",
    "fp8_row_quantize": F8_PY + ":47", "fp8_tensor_quantize": F8_PY + ":86",
    "fp8_block_quantize": F8_PY + ":128", "fp8_matmul_dequant": F8_PY + ":176",
    "fp8_matmul_dequant_t": F8_PY + ":176", "fp8_mixed_matmul": F8_PY + ":258",
    "fp8_mixed_matmul_t": F8_PY + ":258",
}
# the SwitchBack wrappers, forward and input gradient (kernels/switchback/ops.py)
SB_KERNELS = ("tensor_quantize", "fused_switchback_fwd", "row_quantize", "col_quantize",
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


def bound(bytes_, int8_ops=0.0, f32_ops=0.0, bf16_ops=0.0, fp8_ops=0.0):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the peak of their type."""
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = (int8_ops / INT8_OPS_PER_S + fp8_ops / FP8_OPS_PER_S + bf16_ops / BF16_OPS_PER_S
             + f32_ops / F32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_work(torch, KOPS, REF, sets, work, what):
    """Each entry of ``work`` (name: (calls, call(set, ops module), library
    call or None, bytes, int8 ops, f32 ops)) over ``sets``: the kernels'
    and the plain versions' device ms by CUDA-graph replay, the library
    call's, the kernels' eager ms, and the bound; ``what(calls)`` names
    the work timed."""
    out, n = {}, len(sets)
    for name, (calls, call, library, bytes_, i8, f32) in work.items():
        out[name] = dict(
            ms=graph_ms(torch, lambda i: call(sets[i], KOPS), n),
            plain_ms=graph_ms(torch, lambda i: call(sets[i], REF), n),
            library_ms=graph_ms(torch, lambda i: library(sets[i]), n) if library else None,
            eager_ms=eager_ms(torch, lambda i: call(sets[i], KOPS), n),
            bound=bound(bytes_, int8_ops=i8, f32_ops=f32), calls=calls, work=what(calls))
    return out


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
    out = time_work(torch, KOPS, REF, sets, work, lambda c: f"one layer's {c} call(s) at {R} rows")
    for name, r in out.items():
        if r["library_ms"] is not None:
            r["library_rows"] = R + pad
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
    return {**M.KOPS.launch_counts(), **M.FA.launch_counts(), **M.F8.launch_counts()}


def reset_launch_counts(M):
    M.KOPS.reset_launch_counts()
    M.FA.reset_launch_counts()
    M.F8.reset_launch_counts()


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
    SwitchBack and fp8 kernels, and with ``flash`` the four flash kernels."""
    patches = [(M.KOPS, name, getattr(M.REF, name)) for name in SB_KERNELS]
    patches += [(M.F8, name, fn) for name, fn in plain_fp8(M).items()]
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


def kernel_times(torch, fn, n):
    """{CUDA kernel: (device ms, launches) per step} of one ``fn()`` that
    runs ``n`` steps, from torch.profiler recording the card's activity
    only (the host's operator events cost seconds to record and are not
    read)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us and getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type):
            by_kernel[e.key] = (us / n / 1e3, e.count / n)
    return by_kernel


def decode_profile(torch, M, cfg, eng, params, prompts):
    """Wall time and wrapper launches of one full-batch decode step over 10
    steps, and the device time and CUDA launches by kernel over 5
    (torch.profiler). Also returns the batch's cache lengths at the end."""
    import numpy as np

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

    box = [cache]

    def steps(n=5):
        for _ in range(n):
            box[0] = eng.decode(params, box[0], cur)[1]

    by_kernel = kernel_times(torch, steps, 5)
    cache = box[0]
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
# phases 3b and 13: a training path's SwitchBack kernels against their plain
# versions, at that path's shapes
# ---------------------------------------------------------------------------

COLSCALE_KERNELS = ("int8_matmul_dequant_colscale", "int8_matmul_dequant_colscale_t")


def smollm_train_shapes(cfg):
    """Phase 3b's table: one layer's seven linears ``{name: (K, M, needs
    Ẋ)}`` at 2,048 rows and the ragged 8 and 1,000, bf16 and f32, exact
    half-way ties in the weights at 8 rows; tensor-wise modes only."""
    lin = {k: (K, Mw, True) for k, (K, Mw) in path_shapes(cfg).items()}
    dts = ("bfloat16", "float32")
    return [("smollm", R, dts, R == 8, False, lin) for R in (TRAIN_ROWS, 8, 1000)]


def compare_linear_kernels(torch, M, table, dev, seed):
    """Every SwitchBack kernel a training path runs, bit-equal to its plain
    version at the path's shapes. ``table``: (tower, rows, dtypes, ties in
    the weights, column-wise modes too, ``{linear: (K, M, needs Ẋ)}``).
    Per linear: ``tensor_quantize(W)``; per dtype the forward both ways the
    modes take it (fused when K <= FUSED_MAX_CONTRACT, and ``row_quantize``
    + ``int8_matmul_dequant`` at every K, as ``int8_switchback_m`` does)
    and the dgrad (fused when M <= FUSED_MAX_CONTRACT, else
    ``row_quantize`` + ``int8_matmul_dequant_t``); column-wise also
    ``col_quantize(W)``, ``row_quantize(W)``, the colscale forward and the
    transposed colscale dgrad. Inputs hold exact half-way ties and an
    all-zero row. Each kernel run twice on the same inputs must give the
    same bits. Returns the largest |kernel - plain| per kernel and the
    number of comparisons."""
    KOPS, REF = M.KOPS, M.REF
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = dict.fromkeys(SB_KERNELS + COLSCALE_KERNELS, 0.0)
    n = 0
    fused_max = KOPS.FUSED_MAX_CONTRACT

    def same(name, fn, ref, what):
        nonlocal n
        got, again = fn(), fn()
        d = max_abs_diff(torch, got, ref)
        worst[name] = max(worst[name], d)
        check(got.dtype == ref.dtype and got.shape == ref.shape and torch.equal(got, ref),
              f"{name} {what}: kernel != plain (max |diff| {d:g})")
        check(torch.equal(got, again), f"{name} {what}: two launches differ")
        n += 1

    def quantized(name, t, what):
        """The kernel's (int8, scale) of ``t``, each bit-equal to plain."""
        fn = getattr(KOPS, name)
        ref = getattr(REF, name)(t)
        for i in (0, 1):
            same(name, lambda: fn(t)[i], ref[i], f"{what} {'state' if i else 'int8'}")
        return fn(t)

    for tower, R, dts, ties, colwise, linears in table:
        for lin, (K, Mw, dx) in linears.items():
            what = f"{tower} {lin} {K}x{Mw}"
            w = weight(torch, gen, K, Mw, dev, ties)
            w_q, s_w = quantized("tensor_quantize", w, what)
            if colwise:
                c_q, c_s = quantized("col_quantize", w, what)
                w_n, s_n = quantized("row_quantize", w, f"{what} W per input unit")
            for dt in (getattr(torch, d) for d in dts):
                at = f"{what} R={R} {dt}"
                x = activations(torch, gen, R, K, dev, dt)
                if K <= fused_max:
                    same("fused_switchback_fwd", lambda: KOPS.fused_switchback_fwd(x, w_q, s_w),
                         REF.fused_switchback_fwd(x, w_q, s_w), at)
                x_q, s_x = quantized("row_quantize", x, f"{at} X")
                scale = s_x * REF.div(s_w, 127.0 * 127.0)
                same("int8_matmul_dequant",
                     lambda: KOPS.int8_matmul_dequant(x_q, w_q, scale, out_dtype=dt),
                     REF.int8_matmul_dequant(x_q, w_q, scale, out_dtype=dt), at)
                if colwise:
                    row = REF.div(s_x, 127.0 * 127.0)
                    same("int8_matmul_dequant_colscale",
                         lambda: KOPS.int8_matmul_dequant(x_q, c_q, row, col_scale=c_s,
                                                          out_dtype=dt),
                         REF.int8_matmul_dequant(x_q, c_q, row, col_scale=c_s, out_dtype=dt), at)
                if not dx:                        # the patch embedding: data input
                    continue
                g = activations(torch, gen, R, Mw, dev, dt)
                if Mw <= fused_max:
                    same("fused_switchback_dgrad",
                         lambda: KOPS.fused_switchback_dgrad(g, w_q, s_w),
                         REF.fused_switchback_dgrad(g, w_q, s_w), f"{at} dgrad")
                g_q, s_g = quantized("row_quantize", g, f"{at} Ẏ")
                if Mw > fused_max:
                    scale = s_g * REF.div(s_w, 127.0 * 127.0)
                    same("int8_matmul_dequant_t",
                         lambda: KOPS.int8_matmul_dequant_t(g_q, w_q, scale, out_dtype=dt),
                         REF.int8_matmul_dequant_t(g_q, w_q, scale, out_dtype=dt),
                         f"{at} dgrad")
                if colwise:
                    row, col = REF.div(s_g, 127.0 * 127.0), s_n.reshape(1, -1)
                    same("int8_matmul_dequant_colscale_t",
                         lambda: KOPS.int8_matmul_dequant_t(g_q, w_n, row, col_scale=col,
                                                            out_dtype=dt),
                         REF.int8_matmul_dequant_t(g_q, w_n, row, col_scale=col, out_dtype=dt),
                         f"{at} dgrad")
    torch.cuda.synchronize()
    return worst, n


def kv_grads_by_modulo(dk_heads, n_kv):
    """The control fault's dk/dv: a gradient over H query heads' own K/V
    copies (B, S, H, hd) summed onto KV head h % KV (the tiled wiring)."""
    B, S, H, hd = dk_heads.shape
    return dk_heads.reshape(B, S, H // n_kv, n_kv, hd).sum(dim=2)


def gqa_fault(H, KV):
    """The control fault of the GQA shapes: K/V head h % KV instead of
    h // group, its dk/dv summed back onto the KV heads the same way."""
    def fault(q, k, v, causal):
        return (q, kv_heads_by_modulo(k, H), kv_heads_by_modulo(v, H), causal,
                lambda dq, dk, dv: (dq, kv_grads_by_modulo(dk, KV), kv_grads_by_modulo(dv, KV)))
    return fault


def lanes_fault(q, k, v, causal):
    """A control fault at hd > 64: the head dims past 64 dropped."""
    fq, fk, fv = (t.clone() for t in (q, k, v))
    for t in (fq, fk, fv):
        t[..., 64:] = 0
    return fq, fk, fv, causal, lambda *g: g


def mask_fault(q, k, v, causal):
    """A control fault: the causal mask dropped (or added)."""
    return q, k, v, not causal, lambda *g: g


def smollm_flash_cases(cfg):
    """Phase 3c's table: (tower, B, Sq, kv_valid, H, KV, hd, causal, fault):
    8 sequences of 64, 200 and 256 tokens, causal and full, and 256 with
    kv_valid 200; smollm's 15 query heads over 5 KV heads of 64."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    fault = gqa_fault(H, KV)
    cases = [(S, S, c) for S in (64, 200, TRAIN_SEQ) for c in (True, False)]
    cases += [(TRAIN_SEQ, 200, c) for c in (True, False)]
    return [("smollm", TRAIN_BATCH, S, kv, H, KV, hd, c, fault) for S, kv, c in cases]


def compare_flash_train(torch, M, cases, dev, seed):
    """The flash kernels a training path runs against their plain versions
    at its attention shapes (``cases``, see ``smollm_flash_cases``), bf16
    and f32: ``flash_fwd`` (o within FLASH_O_TOL of max|o|, lse within
    FLASH_LSE_TOL), ``flash_bwd_dq`` / ``flash_bwd_dkv`` (f32, within
    FLASH_BWD_TOL of max|grad|, from the kernel forward's o and lse against
    ``ref.mha_bwd``). Each backward kernel run twice must give the same
    bits, keys past kv_valid get no gradient, and each case's control fault
    (the plain versions on faulty inputs) must read FAULT_MARGIN x outside
    every tolerance. Returns the readings per kernel and the number of
    comparisons."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {k: dict(max_abs_err=0.0, max_rel_err=0.0, fault_over_tol=math.inf)
           for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    n = 0

    def record(name, got, want, fault, tol, what):
        nonlocal n
        r = out[name]
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} {what}: bad output")
        err = rel_err(torch, got, want)
        r["max_rel_err"] = max(r["max_rel_err"], err)
        r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(torch, got, want))
        check(err <= tol, f"{name} {what}: kernel vs plain {err:g} > {tol:g}")
        f = rel_err(torch, got, fault) / tol
        r["fault_over_tol"] = min(r["fault_over_tol"], f)
        check(f >= FAULT_MARGIN, f"{name} {what}: the control fault reads only {f:g} x the "
              "tolerance")
        n += 1

    def rand(*shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    for dt in (torch.bfloat16, torch.float32):
        key = str(dt).replace("torch.", "")
        for tower, B, S, kv_valid, H, KV, hd, causal, fault in cases:
            scale = M.FA.softmax_scale(hd)
            q, do = rand(B, S, H, hd, dt=dt), rand(B, S, H, hd, dt=dt)
            k, v = rand(B, S, KV, hd, dt=dt), rand(B, S, KV, hd, dt=dt)
            kw = dict(causal=causal, kv_valid=kv_valid)
            what = f"{tower} B{B} S{S} kv_valid{kv_valid} H{H}/{KV} hd{hd} causal={causal} {dt}"
            o, lse = M.FA.flash_fwd_lse(q, k, v, **kw)
            ro, rlse = M.FREF.mha_fwd(q, k, v, scale=scale, **kw)
            fq, fk, fv, fcausal, back = fault(q, k, v, causal)
            fo, flse = M.FREF.mha_fwd(fq, fk, fv, causal=fcausal, kv_valid=kv_valid, scale=scale)
            record("flash_fwd", o, ro, fo, FLASH_O_TOL[key], what)
            e = float((lse - rlse).abs().max())
            check(e <= FLASH_LSE_TOL, f"flash_fwd {what}: lse off by {e:g}")
            di = M.FREF.attention_di(o, do)
            dq = M.FA.flash_bwd_dq(q, k, v, do, lse, di, **kw)
            dk, dv = M.FA.flash_bwd_dkv(q, k, v, do, lse, di, **kw)
            check(torch.equal(dq, M.FA.flash_bwd_dq(q, k, v, do, lse, di, **kw)),
                  f"flash_bwd_dq {what}: two launches differ")
            check(all(torch.equal(a, b) for a, b in
                      zip((dk, dv), M.FA.flash_bwd_dkv(q, k, v, do, lse, di, **kw))),
                  f"flash_bwd_dkv {what}: two launches differ")
            check(all(t.dtype == torch.float32 for t in (dq, dk, dv)),
                  f"flash backward {what}: gradients not f32")
            rdq, rdk, rdv = M.FREF.mha_bwd(q, k, v, o, lse, do, scale=scale, **kw)
            fdq, fdk, fdv = back(*M.FREF.mha_bwd(fq, fk, fv, fo, flse, do, causal=fcausal,
                                                 kv_valid=kv_valid, scale=scale))
            btol = FLASH_BWD_TOL[key]
            record("flash_bwd_dq", dq, rdq, fdq, btol, what)
            record("flash_bwd_dkv", dk, rdk, fdk, btol, what)
            record("flash_bwd_dkv", dv, rdv, fdv, btol, what)
            check(float(dk[:, kv_valid:].abs().sum()) == 0.0 == float(dv[:, kv_valid:].abs().sum()),
                  f"flash_bwd_dkv {what}: keys past kv_valid got a gradient")
    torch.cuda.synchronize()
    return out, n


# ---------------------------------------------------------------------------
# phases 9-12: the training path
# ---------------------------------------------------------------------------

def train_parts(torch, cfg, dev, *, mode="int8_switchback", compute_dtype=None,
                impl="flash_scan", steps=100, lr=2e-3, warmup=4):
    """(bundle, policy, parallel, TrainConfig, train_step, opt, scaler) of
    a training path: StableAdamW (warm-up ``warmup``, cosine over
    ``steps``), no loss scaling, remat "none"."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.precision import QuantPolicy
    from repro_torch.models import build
    from repro_torch.train import make_train_setup, make_train_step
    bundle = build(cfg)
    policy = QuantPolicy(mode, compute_dtype=compute_dtype or torch.bfloat16)
    parallel = ParallelConfig(remat="none", attn_impl=impl)
    tc = TrainConfig(learning_rate=lr, warmup_steps=warmup, total_steps=steps, quant_mode=mode)
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


def grad_errs(torch, got, want, skip=()):
    """(loss relative error, worst per-leaf max |diff| / max|want|, worst
    per-leaf mean |diff| / max|want|, the leaf of that mean) between two
    (loss, grads) pairs; leaves whose path holds a pattern of ``skip`` are
    left out."""
    (gg, gl), (wg, wl) = got[:2], want[:2]
    loss = abs(float(gl) - float(wl)) / abs(float(wl))
    return (loss, *tree_errs(gg, wg, skip))


def tree_errs(got, want, skip=()):
    """Worst per-leaf (max, mean) |got - want| over the leaf's max|want|,
    and the path of the leaf with the worst mean; leaves whose path holds
    a pattern of ``skip`` are left out."""
    from repro_torch.models.params import tree_paths
    mx = mean = 0.0
    worst = ""
    for (path, a), b in zip(tree_paths(got), (leaf for _, leaf in tree_paths(want))):
        if any(p in path for p in skip):
            continue
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
STEP_KEYS = ("loss_rel_err", "grad_max_rel_err", "grad_mean_rel_err")
STEP_TOL = {"flash_scan": dict(zip(STEP_KEYS, (2e-4, 2e-1, 3e-2))),
            "dense": dict(zip(STEP_KEYS, (1e-6, 1e-5, 1e-6)))}


def step_reading(torch, kern, plain, fault, skip=()):
    """One whole-step case's readings, (loss, grads) with the kernels and
    under the control fault each against the plain versions' (leaves whose
    path holds a pattern of ``skip`` left out), and whether the kernels'
    loss and gradients are finite."""
    from repro_torch.models import params as PRM
    errs, f_errs = grad_errs(torch, kern, plain, skip), grad_errs(torch, fault, plain, skip)
    r = dict(loss=float(kern[1]), loss_plain=float(plain[1]), **dict(zip(STEP_KEYS, errs)),
             worst_mean_leaf=errs[3], **{"fault_" + k: v for k, v in zip(STEP_KEYS, f_errs)})
    finite = math.isfinite(float(kern[1])) and all(
        bool(torch.isfinite(g).all()) for g in PRM.tree_leaves(kern[0]))
    return r, finite


def check_readings(tag, res, finite):
    """Each reading within its ``tolerance`` and its control fault outside
    (at least one of its keys over the limit); called after all are
    printed."""
    for name, r in res.items():
        tol = r["tolerance"]
        check(finite[name], f"{tag} {name}: non-finite loss or gradient")
        check(all(r[k] <= t for k, t in tol.items()),
              f"{tag} {name}: kernels vs plain outside {tol}: {r}")
        check(any(r["fault_" + k] > t for k, t in tol.items()),
              f"{tag} {name}: the control fault lies within {tol}, which so could not see it: {r}")


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
        res[name], finite[name] = step_reading(torch, kern, plain, fault)
        res[name].update(tolerance=STEP_TOL[impl],
                         fault="dw rounded through bf16" if impl == "dense" else "KV head h % KV")
        del kern, plain, fault
    print("[whole step]", json.dumps(res))
    check_readings("whole step", res, finite)
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


def smollm_check_path(torch, M, cfg):
    """Phase 11's path: smollm at 2 layers in int8_switchback, BigramLM
    batches of 4 x 64, the control fault the KV heads tiled."""
    return types.SimpleNamespace(
        tag="card vs cpu", small=dataclasses.replace(cfg, n_layers=2),
        modes=("int8_switchback",), seed_offset=5, tol=CARD_CPU_TOL, opt={},
        batches=lambda n, where, s: bigram_batches(torch, n, 4, 64, where, s),
        keeps=lambda n, s: None, fault="KV heads tiled (CPU)", fault_where="cpu",
        fault_context=lambda: tiled_kv_heads(M), fault_params=lambda t: t,
        fault_back=lambda t: t)


def card_vs_cpu(torch, M, path, dev, seed, steps=3):
    """The same ``steps`` train steps at full width and reduced depth on the
    card and on the CPU from the same parameters, batches and (CLIP) kept
    patches, from CHECK_SEEDS seeds, the seeds taking ``path.modes`` in
    turn; the control fault, run on ``path.fault_where`` (the card when
    None: a fault in the parameters shows on either device, one patched
    into the plain versions only on the CPU), must land outside the
    tolerance against the CPU on each. Leaves that start at zero (biases) are left out of the parameter
    reading: Adam moves an element whose gradient is about 0 by +-lr either
    way in a sound run, so such a leaf's max is a few lr and its reading
    noise. Every reading is printed before any is checked."""
    from repro_torch.models import params as PRM
    from repro_torch.train import init_train_state, make_train_step

    def run(where, mode, p_cpu, batches_cpu, keeps, fault=False):
        bundle, policy, parallel, tc, step, opt, scaler = train_parts(
            torch, path.small, where, mode=mode, **path.opt)
        if keeps is not None:       # the same kept patches on both devices
            feed = iter(keeps)
            step = make_train_step(
                dataclasses.replace(bundle, patch_keep=lambda g: next(feed).to(where)),
                policy, parallel, tc, opt, scaler)
        p0 = path.fault_params(p_cpu) if fault else p_cpu
        state = init_train_state(PRM.tree_map(lambda t: t.clone().to(where), p0), opt, scaler)
        losses = []
        with (path.fault_context() if fault else contextlib.nullcontext()):
            for b in batches_cpu:
                state, m = step(state, {k: v.to(where) for k, v in b.items()})
                losses.append(float(m["loss"]))
        params = PRM.tree_map(lambda t: t.cpu(), state.params)
        return losses, path.fault_back(params) if fault else params

    def errs(a, b, p0):
        zero = tuple(p for p, t in PRM.tree_paths(p0) if not bool(t.abs().max() > 0))
        mx, mean, leaf = tree_errs(a[1], b[1], zero)
        return dict(loss_rel_err=max(abs(x - y) / abs(y) for x, y in zip(a[0], b[0])),
                    param_max_rel_err=mx, param_mean_rel_err=mean, worst_mean_leaf=leaf)

    res = {}
    for j, s in enumerate(check_seeds(seed, path.seed_offset)):
        mode = path.modes[j % len(path.modes)]
        p_cpu = PRM.init_params(param_specs_of(path.small), s, device="cpu")
        batches, keeps = path.batches(steps, "cpu", s), path.keeps(steps, s)
        card = run(dev, mode, p_cpu, batches, keeps)
        cpu = run("cpu", mode, p_cpu, batches, keeps)
        fault = run(path.fault_where or dev, mode, p_cpu, batches, keeps, fault=True)
        res[f"{mode}_seed{s}"] = dict(
            losses_card=card[0], losses_cpu=cpu[0], losses_fault=fault[0],
            **errs(card, cpu, p_cpu), fault=path.fault,
            **{"fault_" + k: v for k, v in errs(fault, cpu, p_cpu).items()})
    print(f"[{path.tag}]", json.dumps(dict(tolerance=path.tol, **res)))
    for name, r in res.items():
        check(all(math.isfinite(x) for x in r["losses_card"]),
              f"{path.tag} {name}: non-finite loss on the card")
        check(all(r[k] <= t for k, t in path.tol.items()),
              f"{path.tag} {name}: {r} outside {path.tol}")
        check(all(r["fault_" + k] > t for k, t in path.tol.items()),
              f"{path.tag} {name}: the control fault lies within {path.tol}: {r}")
    return res


TRAIN_KERNEL_GROUPS = (
    ("fp8_mixed_matmul", "true>", "fp8_mixed_matmul_t"),
    ("fp8_mixed_matmul", "", "fp8_mixed_matmul"),
    ("fp8_matmul_dequant", "true>", "fp8_matmul_dequant_t"),
    ("fp8_matmul_dequant", "", "fp8_matmul_dequant"),
    ("block_quantize", "", "fp8_block_quantize"),
    ("row_quantize", "unsigned char", "fp8_row_quantize"),
    ("cast_tensorwise", "unsigned char", "fp8_tensor_quantize (cast pass)"),
    ("col_quantize", "", "col_quantize"),
    ("fused_fwd_kernel", "true>", "fused_switchback_dgrad"),
    ("fused_fwd_kernel", "", "fused_switchback_fwd"),
    ("int8_matmul_dequant_kernel", "true>", "int8_matmul_dequant_t"),
    ("int8_matmul_dequant_kernel", "", "int8_matmul_dequant"),
    ("row_quantize", "", "row_quantize"),
    ("absmax_partial", "", "tensor_quantize pass 1 (int8 or fp8)"),
    ("cast_tensorwise", "", "tensor_quantize"),
    ("flash_bwd_dq", "", "flash_bwd_dq"),
    ("flash_bwd_dkv", "", "flash_bwd_dkv"),
    ("flash_fwd", "", "flash_fwd"),
)


# PyTorch's own kernels on the train step, by family (lower-case patterns)
TORCH_KERNEL_GROUPS = (
    (("gemm", "nvjet", "xmma", "cutlass", "cublas"),
     "gemm (wgrad, lm head, the simulated fp8 products)"),
    (("reduce_kernel",), "torch reductions (norms, loss, optimizer means, health)"),
    (("index",), "torch gather/scatter (embedding, loss)"),
    (("elementwise", "copy"), "torch elementwise (casts, norms, RoPE, optimizer)"),
)


def train_profile(torch, M, trainer, batches, n_steps=3, rows=TRAIN_ROWS, tag="train profile"):
    """One train step's wall time (over ``n_steps``, ending in a
    synchronize), then its device time, CUDA launches and the device time
    by kernel family from torch.profiler over another ``n_steps``. ``rows``:
    tokens (or image-text pairs) a step trains, for the rate."""
    start = int(trainer.state.step)
    data = lambda i: batches[(i - start) % len(batches)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.run(data, n_steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / n_steps * 1e3
    by_kernel = kernel_times(torch, lambda: trainer.run(data, n_steps), n_steps)
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
    res = dict(step_ms=step_ms, tokens_per_s=rows / step_ms * 1e3,
               device_ms_per_step=dev_ms,
               cuda_launches_per_step=sum(v[1] for v in by_kernel.values()),
               device_idle_share=(max(0.0, 1 - dev_ms / step_ms) if dev_ms else None),
               groups={g: {"ms": v[0], "launches": v[1]} for g, v in
                       sorted(groups.items(), key=lambda kv: -kv[1][0])},
               top=[{"kernel": k[:90], "ms": v[0], "launches": v[1]} for k, v in top])
    if not dev_ms:
        print(f"[{tag}] torch.profiler saw no device time; step wall time only")
    print(f"[{tag}]", json.dumps(res))
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
    out.update(time_work(torch, KOPS, REF, sets, work,
                         lambda c: f"one layer's {c} call(s) at {R} rows"))
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
# phases 13-18: CLIP ViT-H/14, the paper's own model, in the four int8 modes
# ---------------------------------------------------------------------------

CLIP_MODES = ("int8_switchback", "int8_switchback_m", "int8_switchback_q", "int8_llm")
# the CLIP training path: SyntheticCLIP batches of 32 image-text pairs at
# 224 px, patch dropout 0.5 (129 vision tokens with the CLS), 77 text tokens
CLIP_BATCH = 32
CLIP_STEPS = 3            # timed steps per mode, after one warm-up step
# the 2 + 2 layer comparisons of phases 16 and 17: batch (pairs)
CHECK_BATCH, CPU_BATCH = 8, 4


def clip_linears(cfg):
    """(K, M, needs Ẋ) of every SwitchBack linear of one CLIP train step:
    the patch embedding (its input is data: no Ẋ), then each vision and
    text layer's wq, wk, wv, wo (W, W), w_up (W, FF) and w_down (FF, W)."""
    out = [(3 * cfg.patch_size ** 2, cfg.vision_width, False)]
    for L, W, FF in ((cfg.vision_layers, cfg.vision_width, cfg.vision_ff),
                     (cfg.text_layers, cfg.text_width, cfg.text_ff)):
        out += ([(W, W, True)] * 4 + [(W, FF, True), (FF, W, True)]) * L
    return out


def clip_launches_per_step(cfg, mode, fused_max):
    """Each wrapper's launches in one CLIP train step, worked out from the
    layer shapes and the variant's kernel path (``core/switchback.py``):

    * int8_switchback: tensor_quantize(W); forward fused when K <= 2048,
      else row_quantize + int8_matmul_dequant; dgrad fused when M <= 2048,
      else row_quantize + int8_matmul_dequant_t;
    * int8_switchback_m: row_quantize(X), tensor_quantize(W),
      int8_matmul_dequant (never fused); the same dgrad;
    * int8_switchback_q / int8_llm: row_quantize(X), col_quantize(W), the
      colscale matmul; dgrad row_quantize(Ẏ), row_quantize(W), the
      transposed colscale matmul;
    * fp8: fp8 tensor_quantize(W), row_quantize(X), fp8_matmul_dequant;
      dgrad row_quantize(Ẏ), fp8_matmul_dequant_t;
    * fp8_mixed: fp8 tensor_quantize(W), block_quantize(X),
      fp8_mixed_matmul; dgrad block_quantize(Ẏ), fp8_mixed_matmul_t;
    * fp8_sim / fp8_switchback: none (plain products);
    * each layer of both towers: flash_fwd, flash_bwd_dq, flash_bwd_dkv."""
    c = dict.fromkeys(("tensor_quantize", "fused_switchback_fwd", "row_quantize",
                       "col_quantize", "int8_matmul_dequant", "int8_matmul_dequant_colscale",
                       "fused_switchback_dgrad", "int8_matmul_dequant_t",
                       "int8_matmul_dequant_colscale_t", "flash_fwd", "decode_fwd",
                       "flash_bwd_dq", "flash_bwd_dkv", *FP8_KERNELS), 0)
    colwise = mode in ("int8_switchback_q", "int8_llm")
    fp8 = {"fp8": ("fp8_row_quantize", "fp8_matmul_dequant", "fp8_matmul_dequant_t"),
           "fp8_mixed": ("fp8_block_quantize", "fp8_mixed_matmul", "fp8_mixed_matmul_t")}
    for K, Mw, dx in clip_linears(cfg):
        if mode in fp8:
            quant, fwd, dgrad = fp8[mode]
            c["fp8_tensor_quantize"] += 1
            c[quant] += 1 + dx
            c[fwd] += 1
            c[dgrad] += dx
            continue
        if mode.startswith("fp8"):
            continue
        if colwise:
            for k in ("row_quantize", "col_quantize", "int8_matmul_dequant_colscale"):
                c[k] += 1
        elif mode == "int8_switchback_m":
            for k in ("row_quantize", "tensor_quantize", "int8_matmul_dequant"):
                c[k] += 1
        else:
            c["tensor_quantize"] += 1
            if K <= fused_max:
                c["fused_switchback_fwd"] += 1
            else:
                c["row_quantize"] += 1
                c["int8_matmul_dequant"] += 1
        if not dx:
            continue
        if colwise:
            c["row_quantize"] += 2
            c["int8_matmul_dequant_colscale_t"] += 1
        elif Mw <= fused_max:
            c["fused_switchback_dgrad"] += 1
        else:
            c["row_quantize"] += 1
            c["int8_matmul_dequant_t"] += 1
    layers = cfg.vision_layers + cfg.text_layers
    c.update(flash_fwd=layers, flash_bwd_dq=layers, flash_bwd_dkv=layers)
    return c


# the CLIP path's optimizer settings (``train_parts``): lr 1e-3, warm-up 2
CLIP_OPT = dict(lr=1e-3, warmup=2)


def clip_batches(torch, cfg, n, batch, dev, seed):
    """``n`` SyntheticCLIP batches (32 latent classes) on ``dev``."""
    from repro_torch.data import SyntheticCLIP
    data = SyntheticCLIP(cfg.image_size, cfg.text_ctx, cfg.text_vocab, n_classes=32, seed=seed)
    out = []
    for _ in range(n):
        b = data.batch(batch)
        out.append({"images": torch.from_numpy(b["images"]).to(dev),
                    "texts": torch.from_numpy(b["texts"]).to(device=dev, dtype=torch.long)})
    return out


def clip_shapes(cfg):
    """Phase 13's table (see ``compare_linear_kernels``): per tower the
    rows of the main path (phase 15) at CLIP_BATCH, 4,128 vision (129
    tokens after patch dropout), 8,192 patches for the patch embedding
    (before dropout; no Ẋ) and 2,464 text, and ``{name: (K, M, needs Ẋ)}``;
    bf16 as the path runs, the vision tower in f32 too; all four modes."""
    from repro_torch.models.clip import n_kept_patches
    W, FF, Wt, FFt = cfg.vision_width, cfg.vision_ff, cfg.text_width, cfg.text_ff
    bf, both = ("bfloat16",), ("bfloat16", "float32")
    return [
        ("vision", CLIP_BATCH * (n_kept_patches(cfg) + 1), both, True, True,
         {"w_qkvo": (W, W, True), "w_up": (W, FF, True), "w_down": (FF, W, True)}),
        ("patch_embed", CLIP_BATCH * cfg.n_patches, bf, True, True,
         {"patch_embed": (3 * cfg.patch_size ** 2, W, False)}),
        ("text", CLIP_BATCH * cfg.text_ctx, bf, True, True,
         {"w_qkvo": (Wt, Wt, True), "w_up": (Wt, FFt, True), "w_down": (FFt, Wt, True)}),
    ]


def clip_flash_cases(cfg):
    """Phase 14's table (see ``smollm_flash_cases``): the vision tower's
    (32, 129, 16, 80) with no mask, its control fault the lanes past 64
    dropped, and the text tower's (32, 77, 16, 64) causal, its fault the
    mask dropped; no GQA."""
    from repro_torch.models.clip import n_kept_patches
    Sv, Hv, Ht = n_kept_patches(cfg) + 1, cfg.vision_heads, cfg.text_heads
    return [("vision", CLIP_BATCH, Sv, Sv, Hv, Hv, cfg.vision_width // Hv, False, lanes_fault),
            ("text", CLIP_BATCH, cfg.text_ctx, cfg.text_ctx, Ht, Ht, cfg.text_width // Ht, True,
             mask_fault)]


def clip_train(torch, M, cfg, dev, seed, modes=CLIP_MODES, tag="clip train"):
    """Phases 15 and 20: full-width CLIP ViT-H/14 through
    ``make_train_setup``, ``make_train_step`` and ``Trainer`` in each of
    ``modes`` (``int8_switchback`` and ``fp8_sim`` with zero-init
    layer-scale, the paper's recipe, the others with none):
    a warm-up step, then CLIP_STEPS timed steps with every launch counter
    zeroed just before and read just after, each exactly
    ``clip_launches_per_step`` x the steps; every loss finite; peak memory
    over the timed steps; then one step profiled. Returns per mode the
    readings and the counts."""
    from repro_torch.models import params as PRM
    from repro_torch.train import Trainer, init_train_state, loss_and_grads
    res, counts_by_mode = {}, {}
    for mode in modes:
        c = dataclasses.replace(cfg, layer_scale_init=0.0) if mode in ZERO_INIT_MODES else cfg
        bundle, policy, parallel, tc, step, opt, scaler = train_parts(torch, c, dev, mode=mode,
                                                                     **CLIP_OPT)
        t = time.perf_counter()
        params = PRM.init_params(bundle.param_specs, seed, device=dev)
        state = init_train_state(params, opt, scaler, seed=seed)
        batches = clip_batches(torch, c, 1 + CLIP_STEPS, CLIP_BATCH, dev, seed)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in _leaves(params))
        setup_s = time.perf_counter() - t
        del params
        trainer = Trainer(step, state, log_every=1000)
        trainer.run(lambda i: batches[i], 1)                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts(M)
        t = time.perf_counter()
        trainer.run(lambda i: batches[i], CLIP_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = launch_counts(M)
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [h["loss"] for h in trainer.history]
        check(len(losses) == 1 + CLIP_STEPS and all(math.isfinite(x) for x in losses),
              f"CLIP {mode}: non-finite or missing losses {losses}")
        want = clip_launches_per_step(c, mode, M.KOPS.FUSED_MAX_CONTRACT)
        for k, per in want.items():
            check(per == 0 or counts[k] > 0, f"CLIP {mode}: {k} never launched")
            check(counts[k] == per * CLIP_STEPS,
                  f"CLIP {mode}: {k}: {counts[k]} launches in {CLIP_STEPS} steps, expected "
                  f"{per * CLIP_STEPS} ({per} per step)")
        prof = train_profile(torch, M, trainer, batches[1:], n_steps=1, rows=CLIP_BATCH,
                             tag=f"clip profile {mode}")
        # activation memory: the peak of one forward and backward (the
        # gradients included) above what the trainer holds, without the
        # optimizer's copies, which set the step's peak in every mode
        gc.collect()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = loss_and_grads(bundle, policy, parallel, trainer.state.params, batches[1],
                               patch_keep=bundle.patch_keep(trainer.state.rng))
        torch.cuda.synchronize()
        fwd_bwd = (torch.cuda.max_memory_allocated() - base) / 2**30
        del grads
        res[mode] = dict(layer_scale_init=c.layer_scale_init, n_params=n_params,
                         setup_s=setup_s, step_ms=wall / CLIP_STEPS * 1e3,
                         pairs_per_s=CLIP_STEPS * CLIP_BATCH / wall, losses=losses,
                         grad_norms=[h["grad_norm"] for h in trainer.history],
                         peak_memory_gib=peak, fwd_bwd_peak_gib_above_state=fwd_bwd,
                         launches_per_step={k: v / CLIP_STEPS for k, v in counts.items()},
                         profile={k: prof[k] for k in ("step_ms", "device_ms_per_step",
                                                       "device_idle_share",
                                                       "cuda_launches_per_step", "groups")})
        counts_by_mode[mode] = counts
        print(f"[{tag}] {mode}: " + json.dumps({k: v for k, v in res[mode].items()
                                                if k != "profile"}))
        del trainer, state, batches, step, opt
        gc.collect()                 # the autograd graph's cycles hold card memory
        torch.cuda.empty_cache()
    print(f"[{tag}] peak memory GiB (step; one forward and backward above the state): "
          + json.dumps({m: [r["peak_memory_gib"], r["fwd_bwd_peak_gib_above_state"]]
                        for m, r in res.items()}))
    return res, counts_by_mode


def rolled_pos_embed(torch, tree, shift=-1):
    """The control fault of phases 16-17, a one-character slip: the vision
    tower reads its positional embedding one row off (the CLS takes row 1,
    patch i row i + 2, the last patch row 0). ``shift=1`` turns a
    parameter or gradient tree of the faulty run back into the sound
    run's row order, so every leaf is compared with its own."""
    pos = tree["visual"]["pos_embed"]
    return dict(tree, visual=dict(tree["visual"],
                                  pos_embed=torch.roll(pos, shift, dims=1).contiguous()))


# one CLIP train step at 2 + 2 layers (full width), kernels against plain
# versions under flash_scan in bf16: per-leaf max and mean |diff| of the
# gradient relative to the leaf's max. Each limit is the geometric mean of
# the worst sound reading and the smallest reading of the control fault
# (the positional embedding read one row off) over three seeds on an H100,
# one digit (the rule of phase 10; readings in PERF.md): max 1.22e-1
# against 1.36, mean 2.10e-2 against 1.91e-1. The loss is printed, not
# bounded: at random weights it sits at chance (ln 8), and the sound
# readings (up to 6.2e-4) overlap the fault's (from 3.5e-4). Two leaves are
# printed apart, not read per leaf: the key bias, whose exact gradient is 0
# (softmax ignores a per-query constant), and the 0-d logit_scale, whose
# gradient at chance is a sum that nearly cancels (sound readings up to
# 1.0e-1 of its own size). Under dense every kernel on the path is
# bit-equal to its plain version, so the step is.
CLIP_STEP_TOL = {"grad_max_rel_err": 4e-1, "grad_mean_rel_err": 6e-2}
CLIP_NOISE_LEAVES = ("['attn']['bk']", "['logit_scale']")


def clip_whole_step(torch, M, cfg, dev, seed, modes=CLIP_MODES, tol=CLIP_STEP_TOL,
                    tag="clip whole step"):
    """Phases 16 and 21: one train step's loss and gradients at 2 + 2
    layers and full width, kernels against their plain versions swapped
    in, in each of ``modes`` from CHECK_SEEDS seeds (layer_scale_init None:
    with γ = 0 every block linear's Ẏ is exactly 0 at step 0), within ``tol``;
    the control fault (``rolled_pos_embed``, plain) outside. Under dense
    attention, one seed per mode, bit-equal. Every reading is printed
    before any is checked."""
    from repro_torch.models import params as PRM
    from repro_torch.models.clip import patch_keep_sampler
    from repro_torch.train import loss_and_grads
    small = dataclasses.replace(cfg, vision_layers=2, text_layers=2)
    draw = patch_keep_sampler(small)
    res, bitwise, finite = {}, {}, {}
    for s in check_seeds(seed, 7):
        params = PRM.init_params(param_specs_of(small), s, device=dev)
        fault_params = rolled_pos_embed(torch, params)
        batch = clip_batches(torch, small, 1, CHECK_BATCH, dev, s)[0]
        keep = draw(torch.Generator(device=dev).manual_seed(s))
        for mode in modes:
            name = f"{mode}_seed{s}"
            bundle, policy, parallel, *_ = train_parts(torch, small, dev, mode=mode, **CLIP_OPT)
            run = lambda p: loss_and_grads(bundle, policy, parallel, p, batch, patch_keep=keep)
            kern = run(params)
            with plain_ops(M, flash=True):
                plain, fault = run(params), run(fault_params)
            fault = (rolled_pos_embed(torch, fault[0], 1), *fault[1:])
            res[name], finite[name] = step_reading(torch, kern, plain, fault, CLIP_NOISE_LEAVES)
            res[name].update(tolerance=tol, fault="pos_embed rolled",
                             logit_scale_grad=[float(g[0]["logit_scale"]) for g in (kern, plain)])
            if s == check_seeds(seed, 7)[0]:
                b_bundle, b_policy, b_parallel, *_ = train_parts(
                    torch, small, dev, mode=mode, impl="dense", **CLIP_OPT)
                dense = lambda: loss_and_grads(b_bundle, b_policy, b_parallel, params, batch,
                                               patch_keep=keep)
                dk = dense()
                with plain_ops(M, flash=False):
                    dp = dense()
                bitwise[mode] = bool(torch.equal(dk[1], dp[1])) and all(
                    torch.equal(a, b) for a, b in zip(PRM.tree_leaves(dk[0]),
                                                      PRM.tree_leaves(dp[0])))
            del kern, plain, fault
    print(f"[{tag}]", json.dumps(dict(dense_bitwise=bitwise, **res)))
    for mode, ok in bitwise.items():
        check(ok, f"{tag} {mode}, dense: kernels != plain")
    check_readings(tag, res, finite)
    return res


# card against CPU (``card_vs_cpu``) at 2 + 2 layers and full width:
# (loss relative per step, the final parameters' worst per-leaf mean |diff|
# over the leaf's max, the leaves that start at zero left out). The
# parameters' per-leaf max is printed, not bounded (sound up to 5.4e-2,
# the fault from 5.6e-2). Limits by the rule of phase 10 over three seeds
# and both modes on an H100, the fault then run on the CPU (readings in
# PERF.md): loss 3.0e-3 against 7.5e-2, parameter mean 1.15e-3 against
# 1.19e-2.
CLIP_CARD_CPU_TOL = {"loss_rel_err": 1e-2, "param_mean_rel_err": 4e-3}


def clip_check_path(torch, cfg, modes=("int8_switchback_q", "int8_llm"),
                    tol=CLIP_CARD_CPU_TOL, tag="clip card vs cpu", seed_offset=11):
    """Phases 17 and 22's path: CLIP at 2 + 2 layers in ``modes``, those
    that run a slice's new kernels (the seeds take them in turn), SyntheticCLIP batches of
    CPU_BATCH pairs with each step's kept patches drawn beforehand, the
    control fault the positional embedding read one row off, on the card
    (one CPU run per seed fewer)."""
    from repro_torch.models.clip import patch_keep_sampler
    small = dataclasses.replace(cfg, vision_layers=2, text_layers=2)
    draw = patch_keep_sampler(small)
    return types.SimpleNamespace(
        tag=tag, small=small, modes=modes, seed_offset=seed_offset, tol=tol, opt=CLIP_OPT,
        batches=lambda n, where, s: clip_batches(torch, small, n, CPU_BATCH, where, s),
        keeps=lambda n, s: [draw(torch.Generator().manual_seed(s + i)) for i in range(n)],
        fault="pos_embed rolled (card)", fault_where=None, fault_context=contextlib.nullcontext,
        fault_params=lambda t: rolled_pos_embed(torch, t),
        fault_back=lambda t: rolled_pos_embed(torch, t, 1))


def time_clip_kernels(torch, M, cfg, dev, seed):
    """Phase 18: the new kernels at CLIP's shapes, one vision layer's calls
    of the column-wise modes at batch 32 (4,128 rows): col_quantize of the
    six weights, the colscale forward of the six linears and their
    transposed colscale dgrad; each with its plain version, the library
    yardstick (``torch._int_mm`` plus the rank-1 scale) for the matmuls,
    and the bound."""
    KOPS, REF = M.KOPS, M.REF
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    _, R, _, _, _, shapes = clip_shapes(cfg)[0]                         # the vision tower
    lin = [shapes[k][:2] for k in ("w_qkvo",) * 4 + ("w_up", "w_down")]    # (K, M)

    def one_set():
        s = {"w": [], "fwd": [], "dgrad": []}
        for K, Mw in lin:
            w = weight(torch, gen, K, Mw, dev)
            w_q, s_w = KOPS.col_quantize(w)
            x_q, s_x = KOPS.row_quantize(activations(torch, gen, R, K, dev))
            g_q, s_g = KOPS.row_quantize(activations(torch, gen, R, Mw, dev))
            w_n, s_n = KOPS.row_quantize(w)
            s["w"].append(w)
            s["fwd"].append((x_q, w_q, REF.div(s_x, 127.0 * 127.0), s_w))
            s["dgrad"].append((g_q, w_n, REF.div(s_g, 127.0 * 127.0), s_n.reshape(1, -1)))
        return s

    per_set = sum(3 * K * Mw + 2 * R * (K + Mw) for K, Mw in lin)
    sets = [one_set() for _ in range(max(2, int(120e6 // per_set) + 1))]
    torch.cuda.synchronize()

    def int_mm(x_q, w_q, row, col):
        return (torch._int_mm(x_q, w_q).float() * (row * col)).to(torch.bfloat16)

    def int_mm_t(g_q, w_n, row, col):
        return (torch._int_mm(g_q, w_n.t()).float() * (row * col)).to(torch.bfloat16)

    a, b = sets[0]["fwd"][4], sets[0]["dgrad"][4]
    check(torch.equal(int_mm(*a), KOPS.int8_matmul_dequant(a[0], a[1], a[2], col_scale=a[3])),
          "torch._int_mm yardstick disagrees with the colscale int8_matmul_dequant")
    check(torch.equal(int_mm_t(*b), KOPS.int8_matmul_dequant_t(b[0], b[1], b[2], col_scale=b[3])),
          "torch._int_mm yardstick disagrees with the colscale int8_matmul_dequant_t")
    n_w = sum(K * Mw for K, Mw in lin)
    work = {
        # name: (calls, call(set, ops module), library call, bytes, int8 ops, f32 ops)
        "col_quantize": (len(lin), lambda s, op: [op.col_quantize(w) for w in s["w"]], None,
                         n_w * 2 + n_w + sum(4 * Mw for _, Mw in lin), 0, 4 * n_w),
        "int8_matmul_dequant_colscale": (
            len(lin),
            lambda s, op: [op.int8_matmul_dequant(x, w, r, col_scale=c) for x, w, r, c in s["fwd"]],
            lambda s: [int_mm(*t) for t in s["fwd"]],
            sum(R * K + K * Mw + 4 * R + 4 * Mw + 2 * R * Mw for K, Mw in lin),
            sum(2 * R * K * Mw for K, Mw in lin), sum(2 * R * Mw for _, Mw in lin)),
        "int8_matmul_dequant_colscale_t": (
            len(lin), lambda s, op: [op.int8_matmul_dequant_t(g, w, r, col_scale=c)
                           for g, w, r, c in s["dgrad"]],
            lambda s: [int_mm_t(*t) for t in s["dgrad"]],
            sum(R * Mw + K * Mw + 4 * R + 4 * K + 2 * R * K for K, Mw in lin),
            sum(2 * R * K * Mw for K, Mw in lin), sum(2 * R * K for K, _ in lin)),
    }
    out = time_work(torch, KOPS, REF, sets, work,
                    lambda c: f"one vision layer's {c} calls at {R} rows (batch {CLIP_BATCH})")
    del sets
    print("[timing] clip kernels:", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phases 19-23: CLIP ViT-H/14 in the four fp8 modes, on the fp8 kernels
# ---------------------------------------------------------------------------

CLIP_FP8_MODES = ("fp8_sim", "fp8", "fp8_mixed", "fp8_switchback")
# the modes whose linears run the fp8 kernels (the other two are plain
# f32 products of fp8 values, the paper's simulation)
FP8_KERNEL_MODES = ("fp8", "fp8_mixed")
# zero-init layer-scale, the paper's recipe: int8_switchback and fp8_sim
ZERO_INIT_MODES = ("int8_switchback", "fp8_sim")
# fp8_mixed_matmul kernel vs plain, stated before its first card run: each
# tile's double sum is exact unless its products span more than about 18
# binades, and then only that sum's rounding to f32 may differ. At most
# this share of the outputs may differ, each by at most this many units in
# the last place of the output type. The control fault (the fallback bits
# dropped, every tile in fp8) changes every output of an outlier tile's
# rows.
MIXED_TOL = (1e-4, 1)
_INT_VIEW = {"float32": "int32", "bfloat16": "int16"}


def fp8_activations(torch, gen, R, K, dev, dtype, outliers):
    """Random rows over several binades; row 1 holds exact fp8 ties at
    scale 1 (multiples of 1/64 in [-1, 1]: the midpoints of both formats'
    grids in [1/4, 1)), row 2 is all zero, and rows 128-255 of the first
    128 columns an all-zero tile. With ``outliers`` rows 256-383 of the
    first 128 columns are 40x and the last element 500: tiles that fall
    back to bf16 in fp8_mixed."""
    x = torch.randn((R, K), generator=gen, device=dev) * 3
    x = x * torch.exp(torch.empty((R, 1), device=dev).uniform_(-4, 4, generator=gen))
    x[1] = ((torch.arange(K, device=dev) % 129) - 64).float() / 64
    x[2] = 0.0
    if R > 256:
        x[128:256, :128] = 0.0
    if outliers and R > 384:
        x[256:384, :128] *= 40.0
        x[-1, -1] = 500.0
    return x.to(dtype)


def mixed_reading(torch, got, want):
    """(share of outputs that differ, largest difference in ulps of the
    output type)."""
    iv = getattr(torch, _INT_VIEW[str(want.dtype).replace("torch.", "")])
    diff = got != want
    if not bool(diff.any()):
        return 0.0, 0
    ulps = (got.view(iv).long() - want.view(iv).long()).abs()
    return float(diff.float().mean()), int(ulps[diff].max())


def as_bits(torch, t):
    """An fp8 tensor as its bytes (so that equality is bitwise), else itself."""
    return t.view(torch.uint8) if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2) else t


def compare_fp8_kernels(torch, M, table, dev, seed):
    """Phase 19: every fp8 kernel of the fp8 and fp8_mixed modes against its
    plain version at the shapes the main path (phase 20) gives it:
    ``table`` as ``clip_shapes`` (every weight of both towers at batch 32:
    4,128 vision rows, 8,192 patch rows at K = 588, 2,464 text rows). Per
    linear: ``tensor_quantize(W)`` in E4M3; per dtype the forward
    (``row_quantize`` E4M3 + ``fp8_matmul_dequant``; ``block_quantize`` +
    ``fp8_mixed_matmul``) and, where the layer has an input gradient, the
    dgrad (``row_quantize`` E5M2 + ``fp8_matmul_dequant_t``;
    ``block_quantize`` E5M2 + ``fp8_mixed_matmul_t``). The inputs hold fp8
    ties, an all-zero row, an all-zero tile and outlier tiles that fall back.
    The quantizers and both forms of ``fp8_matmul_dequant`` must be
    bit-equal, ``fp8_mixed_matmul`` within MIXED_TOL with its control fault
    (fallback dropped) outside; each run twice gives the same bits. Returns
    per kernel the largest |kernel - plain| (the quantizers' decoded
    values), the mixed readings and the number of comparisons."""
    F8, F8REF = M.F8, M.F8REF
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = dict.fromkeys(FP8_KERNELS, 0.0)
    mixed = dict(max_share=0.0, max_ulps=0, fault_min_share=math.inf, tiles=0, fallback_tiles=0)
    n = 0

    def twice(fn, what):
        a, b = fn(), fn()
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            check(torch.equal(as_bits(torch, x), as_bits(torch, y)), f"{what}: two launches differ")
        return a

    def quantized(key, name, args, what):
        nonlocal n
        got = twice(lambda: getattr(F8, name)(*args), f"{key} {what}")
        want = getattr(F8REF, name)(*args)
        for g, w, part in zip(got, want, ("fp8", "state")):
            ok = g.dtype == w.dtype and g.shape == w.shape and torch.equal(
                as_bits(torch, g), as_bits(torch, w))
            worst[key] = max(worst[key], max_abs_diff(torch, g.float(), w.float()))
            check(ok, f"{key} {what} {part}: kernel != plain")
            n += 1
        return got

    def matmul(key, fn, plain, what):
        nonlocal n
        got, want = twice(fn, f"{key} {what}"), plain()
        worst[key] = max(worst[key], max_abs_diff(torch, got, want))
        check(got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want),
              f"{key} {what}: kernel != plain (max |diff| {max_abs_diff(torch, got, want):g})")
        n += 1

    def mixed_pair(key, a, fmt, w_q, s_w, tw, dt, what):
        nonlocal n
        a_q, s_blk = quantized("fp8_block_quantize", "block_quantize", (a, fmt), what)
        fb = F8.fallback_mask(s_blk, 8.0)
        fn = F8.fp8_mixed_matmul_t if tw else F8.fp8_mixed_matmul
        got = twice(lambda: fn(a, a_q, s_blk, fb, w_q, s_w, out_dtype=dt), f"{key} {what}")
        kw = dict(block_rows=128, block_cols=128, transpose_w=tw, out_dtype=dt)
        want = F8REF.fp8_mixed_matmul(a, a_q, s_blk, fb, w_q, s_w, **kw)
        fault = fn(a, a_q, s_blk, torch.zeros_like(fb), w_q, s_w, out_dtype=dt)
        share, ulps = mixed_reading(torch, got, want)
        f_share, _ = mixed_reading(torch, fault, want)
        worst[key] = max(worst[key], max_abs_diff(torch, got, want))
        mixed.update(max_share=max(mixed["max_share"], share),
                     max_ulps=max(mixed["max_ulps"], ulps),
                     fault_min_share=min(mixed["fault_min_share"], f_share),
                     tiles=mixed["tiles"] + fb.numel(),
                     fallback_tiles=mixed["fallback_tiles"] + int(fb.sum()))
        check(0 < float(fb.sum()) < fb.numel(), f"{key} {what}: not both branches ran")
        check(share <= MIXED_TOL[0] and ulps <= MIXED_TOL[1],
              f"{key} {what}: {share:g} of outputs differ, by up to {ulps} ulps, "
              f"outside {MIXED_TOL}")
        check(f_share > MIXED_TOL[0], f"{key} {what}: the control fault (fallback dropped) "
              f"reads {f_share:g}, inside {MIXED_TOL}")
        n += 1

    for tower, R, dts, _, _, linears in table:
        for lin, (K, Mw, dx) in linears.items():
            what = f"{tower} {lin} {K}x{Mw} R={R}"
            w = weight(torch, gen, K, Mw, dev)
            w_q, s_w = quantized("fp8_tensor_quantize", "tensor_quantize", (w, "e4m3"), what)
            for dt in (getattr(torch, d) for d in dts):
                at = f"{what} {dt}"
                x = fp8_activations(torch, gen, R, K, dev, dt, outliers=True)
                x_q, s_x = quantized("fp8_row_quantize", "row_quantize", (x, "e4m3"), at)
                matmul("fp8_matmul_dequant",
                       lambda: F8.fp8_matmul_dequant(x_q, w_q, s_x * s_w, out_dtype=dt),
                       lambda: F8REF.fp8_matmul_dequant(x_q, w_q, s_x * s_w, out_dtype=dt), at)
                mixed_pair("fp8_mixed_matmul", x, "e4m3", w_q, s_w, False, dt, at)
                if not dx:                        # the patch embedding: data input
                    continue
                g = fp8_activations(torch, gen, R, Mw, dev, dt, outliers=True)
                g_q, s_g = quantized("fp8_row_quantize", "row_quantize", (g, "e5m2"), f"{at} Ẏ")
                matmul("fp8_matmul_dequant_t",
                       lambda: F8.fp8_matmul_dequant_t(g_q, w_q, s_g * s_w, out_dtype=dt),
                       lambda: F8REF.fp8_matmul_dequant(g_q, w_q, s_g * s_w, transpose_w=True,
                                                        out_dtype=dt), f"{at} dgrad")
                mixed_pair("fp8_mixed_matmul_t", g, "e5m2", w_q, s_w, True, dt, f"{at} dgrad")
    torch.cuda.synchronize()
    return worst, mixed, n


def plain_fp8(M):
    """The fp8 wrappers' plain versions behind the wrappers' signatures."""
    R = M.F8REF
    return {
        "row_quantize": R.row_quantize, "tensor_quantize": R.tensor_quantize,
        "block_quantize": R.block_quantize,
        "fp8_matmul_dequant": lambda x_q, w_q, rs, *, out_dtype: R.fp8_matmul_dequant(
            x_q, w_q, rs, out_dtype=out_dtype),
        "fp8_matmul_dequant_t": lambda x_q, w_q, rs, *, out_dtype: R.fp8_matmul_dequant(
            x_q, w_q, rs, transpose_w=True, out_dtype=out_dtype),
        "fp8_mixed_matmul": lambda *a, block_rows, block_cols, out_dtype: R.fp8_mixed_matmul(
            *a, block_rows=block_rows, block_cols=block_cols, out_dtype=out_dtype),
        "fp8_mixed_matmul_t": lambda *a, block_rows, block_cols, out_dtype: R.fp8_mixed_matmul(
            *a, block_rows=block_rows, block_cols=block_cols, transpose_w=True,
            out_dtype=out_dtype),
    }


# the fp8 whole-step checks of phase 21 (kernels vs plain at 2 + 2 layers,
# flash_scan), per-leaf max and mean |diff| of the gradient over the
# leaf's max. The fp8 quantizers turn a last-bit difference of the flash
# kernels' sums into a step of 2^-4 (E4M3) or 2^-3 (E5M2) of a value, so
# the sound readings sit above the int8 modes'. Limits by the rule of
# phase 10 over three seeds and both modes on an H100 (readings in
# PERF.md): max 5.64e-1 against the fault's 1.34, mean 8.13e-2 against
# 1.91e-1. The loss is printed, not bounded (as in phase 16). Under dense
# attention both fp8 modes are bit-equal.
CLIP_FP8_STEP_TOL = {"grad_max_rel_err": 9e-1, "grad_mean_rel_err": 1e-1}


def time_fp8_kernels(torch, M, cfg, dev, seed):
    """Phase 23: each fp8 kernel at one vision layer's calls at batch 32
    (4,128 rows; the six linears wq, wk, wv, wo, w_up, w_down): the fp8
    mode's tensor_quantize of the six weights, row_quantize of X (E4M3)
    and Ẏ (E5M2), fp8_matmul_dequant and its transposed form;
    fp8_mixed's block_quantize of X and Ẏ and both mixed forms (with the
    fallback tiles of these inputs). Each beside its plain version, the
    bound (bytes over 3.35 TB/s; the matmuls' operations over the fp8 peak
    of 1,979 TFLOP/s, the fallback tiles' over the bf16 peak) and, for the
    matmuls, ``torch._scaled_mm`` with row-wise scales (timed only; the
    port never calls it)."""
    F8, F8REF = M.F8, M.F8REF
    gen = torch.Generator(device=dev).manual_seed(seed + 37)
    _, R, _, _, _, shapes = clip_shapes(cfg)[0]
    lin = [shapes[k][:2] for k in ("w_qkvo",) * 4 + ("w_up", "w_down")]    # (K, M)
    bf = torch.bfloat16

    def one_set():
        s = {"w": [], "x": [], "g": [], "fwd": [], "dgrad": [], "mix": [], "mix_t": []}
        for K, Mw in lin:
            w = weight(torch, gen, K, Mw, dev)
            w_q, s_w = F8.tensor_quantize(w, "e4m3")
            x = fp8_activations(torch, gen, R, K, dev, bf, outliers=True)
            g = fp8_activations(torch, gen, R, Mw, dev, bf, outliers=True)
            x_q, s_x = F8.row_quantize(x, "e4m3")
            g_q, s_g = F8.row_quantize(g, "e5m2")
            s["w"].append(w)
            s["x"].append(x)
            s["g"].append(g)
            s["fwd"].append((x_q, w_q, s_x * s_w))
            s["dgrad"].append((g_q, w_q, s_g * s_w))
            for key, a, fmt in (("mix", x, "e4m3"), ("mix_t", g, "e5m2")):
                a_q, s_blk = F8.block_quantize(a, fmt)
                s[key].append((a, a_q, s_blk, F8.fallback_mask(s_blk, 8.0), w_q, s_w))
        return s

    per_set = sum(K * Mw * 4 + R * (K + Mw) * 8 for K, Mw in lin)
    sets = [one_set() for _ in range(max(2, int(120e6 // per_set) + 1))]
    torch.cuda.synchronize()
    fb_share = {key: sum(float(t[3].sum()) for t in sets[0][key]) /
                sum(t[3].numel() for t in sets[0][key]) for key in ("mix", "mix_t")}

    def scaled_mm(a_q, w_cm, row_scale, ones):
        """torch._scaled_mm with row-wise scales: a_q (B, K) row-major, W
        as the column-major (K, M) it wants, the row scale (B, 1) and ones
        (1, M) for the columns, bf16 out."""
        return torch._scaled_mm(a_q, w_cm, scale_a=row_scale, scale_b=ones, out_dtype=bf)

    # the forward's (K, M) W as a column-major copy, made outside the
    # timing; the dgrad's (N, M) W read transposed is column-major already
    col_major = {key: [(a, w.t().contiguous().t() if key == "fwd" else w.t(), rs,
                        torch.ones((1, w.shape[1] if key == "fwd" else w.shape[0]), device=dev))
                       for a, w, rs in sets[0][key]] for key in ("fwd", "dgrad")}
    library, lib_err = {}, {}
    for key, kernel in (("fwd", F8.fp8_matmul_dequant), ("dgrad", F8.fp8_matmul_dequant_t)):
        y, want = scaled_mm(*col_major[key][4]), kernel(*sets[0][key][4])
        lib_err[key] = rel_err(torch, y.float(), want.float())
        check(lib_err[key] <= 2.0 ** -6, f"torch._scaled_mm yardstick ({key}) disagrees "
              f"with the kernel: {lib_err[key]:g}")
        library[key] = lambda i, key=key: [scaled_mm(*t) for t in col_major[key]]
    print("[timing] fp8 yardstick torch._scaled_mm vs kernel (relative to max|y|): "
          + json.dumps(lib_err))

    n_w = sum(K * Mw for K, Mw in lin)
    rk = sum(R * K for K, _ in lin)
    rm = sum(R * Mw for _, Mw in lin)
    mac = sum(R * K * Mw for K, Mw in lin)
    work = {
        # name: (calls, call(set, module, plain), library call, bytes, fp8 ops, bf16 ops, f32 ops)
        "fp8_tensor_quantize": (len(lin), lambda s, op, p: [op.tensor_quantize(w, "e4m3")
                                                            for w in s["w"]], None,
                                n_w * 2 + n_w + 4 * len(lin), 0, 0, 2 * n_w),
        "fp8_row_quantize": (2 * len(lin), lambda s, op, p: [op.row_quantize(x, "e4m3")
                                                             for x in s["x"]]
                             + [op.row_quantize(g, "e5m2") for g in s["g"]], None,
                             (rk + rm) * 3 + 4 * R * 2 * len(lin), 0, 0, 2 * (rk + rm)),
        "fp8_block_quantize": (2 * len(lin), lambda s, op, p: [op.block_quantize(x, "e4m3")
                                                               for x in s["x"]]
                               + [op.block_quantize(g, "e5m2") for g in s["g"]], None,
                               (rk + rm) * 3, 0, 0, 2 * (rk + rm)),
        "fp8_matmul_dequant": (len(lin), lambda s, op, p: [p("fp8_matmul_dequant")(
            *a, out_dtype=bf) for a in s["fwd"]], "fwd",
            rk + n_w + 4 * R * len(lin) + 2 * rm, 2 * mac, 0, 0),
        "fp8_matmul_dequant_t": (len(lin), lambda s, op, p: [p("fp8_matmul_dequant_t")(
            *a, out_dtype=bf) for a in s["dgrad"]], "dgrad",
            rm + n_w + 4 * R * len(lin) + 2 * rk, 2 * mac, 0, 0),
        "fp8_mixed_matmul": (len(lin), lambda s, op, p: [p("fp8_mixed_matmul")(
            *a, block_rows=128, block_cols=128, out_dtype=bf) for a in s["mix"]], "fwd",
            rk * 3 + n_w + 2 * rm, 2 * mac * (1 - fb_share["mix"]), 2 * mac * fb_share["mix"], 0),
        "fp8_mixed_matmul_t": (len(lin), lambda s, op, p: [p("fp8_mixed_matmul_t")(
            *a, block_rows=128, block_cols=128, out_dtype=bf) for a in s["mix_t"]], "dgrad",
            rm * 3 + n_w + 2 * rk, 2 * mac * (1 - fb_share["mix_t"]),
            2 * mac * fb_share["mix_t"], 0),
    }
    kern = lambda name: getattr(F8, name)
    plain = plain_fp8(M)
    out, n = {}, len(sets)
    for name, (calls, call, lib, bytes_, f8, b16, f32) in work.items():
        lib_fn = library[lib] if lib else None
        out[name] = dict(
            ms=graph_ms(torch, lambda i: call(sets[i], F8, kern), n),
            plain_ms=graph_ms(torch, lambda i: call(sets[i], F8REF, plain.__getitem__), n),
            library_ms=graph_ms(torch, lib_fn, 1) if lib_fn else None,
            library="torch._scaled_mm, row-wise scales, bf16 out" if lib_fn else None,
            eager_ms=eager_ms(torch, lambda i: call(sets[i], F8, kern), n),
            bound=bound(bytes_, fp8_ops=f8, bf16_ops=b16, f32_ops=f32), calls=calls,
            work=f"one vision layer's {calls} calls at {R} rows (batch {CLIP_BATCH})")
    out["fallback_share"] = fb_share
    del sets
    print("[timing] fp8 kernels:", json.dumps(out))
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
    from repro_torch.kernels.fp8_matmul import build as F8B
    from repro_torch.kernels.fp8_matmul import ops as F8
    from repro_torch.kernels.fp8_matmul import ref as F8REF
    from repro_torch.kernels.switchback import build as KB
    from repro_torch.kernels.switchback import ops as KOPS
    from repro_torch.kernels.switchback import ref as REF
    from repro_torch.serve import make_serve_engine
    M = types.SimpleNamespace(KOPS=KOPS, REF=REF, FA=FA, FREF=FREF, F8=F8, F8REF=F8REF)

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
    secs = {}

    @contextlib.contextmanager
    def timed(name):
        """Seconds of the phase ``name`` into ``secs``, printed as it ends."""
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        print(f"[time] {name}: {secs[name]:.1f} s", flush=True)

    with timed("2 build"):
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            builds = {lib: pool.submit(mod.build) for lib, mod in
                      (("switchback", KB), ("flash_attention", FB), ("fp8_matmul", F8B))}
            built = {lib: f.result() for lib, f in builds.items()}
        KB.load()
        FB.load()
        F8B.load()
    for lib, (lib_path, log) in built.items():
        print(f"[build] {os.path.relpath(lib_path, ROOT)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib}:", line.strip())

    cfg = get_config("smollm-360m")
    # 3. kernels vs plain
    with timed("3 kernels vs plain"):
        worst, n_cmp = compare_kernels(torch, KOPS, REF, cfg, dev, args.seed)
        print(f"[kernels] {n_cmp} SwitchBack comparisons bit-equal; max |kernel - plain| "
              + json.dumps(worst))
        flash_worst, n_flash = compare_flash(torch, M, cfg, dev, args.seed)
        print(f"[kernels] {n_flash} flash comparisons within o {json.dumps(FLASH_O_TOL)} of "
              f"max|o|, lse {FLASH_LSE_TOL:g}; control fault >= {FAULT_MARGIN:g}x the "
              "tolerance: " + json.dumps(flash_worst))
        train_worst, n_train = compare_linear_kernels(torch, M, smollm_train_shapes(cfg), dev,
                                                      args.seed + 13)
        print(f"[kernels] {n_train} train-path SwitchBack comparisons bit-equal and "
              "bit-identical over two launches; max |kernel - plain| " + json.dumps(train_worst))
        bwd_worst, n_bwd = compare_flash_train(torch, M, smollm_flash_cases(cfg), dev,
                                               args.seed + 17)
        print(f"[kernels] {n_bwd} train-path flash comparisons within o "
              f"{json.dumps(FLASH_O_TOL)}, backward {json.dumps(FLASH_BWD_TOL)} of max|grad|, "
              f"bit-identical over two launches; control fault >= {FAULT_MARGIN:g}x the "
              "tolerance: " + json.dumps(bwd_worst))

    # 4. serve (the main path)
    with timed("4-6 serve, whole model, reference"):
        eng, params, prompts, stats, counts = serve(torch, M, cfg, dev, args.seed)
        engines = {"flash_scan": eng, "dense": make_serve_engine(
            "smollm-360m", eng.serve_cfg,
            parallel=ParallelConfig(remat="none", attn_impl="dense"), device=dev)}
        # 5. whole model, kernels vs plain
        whole_model(torch, M, engines, params, prompts)
        # 6. reference
        reference(torch, M, cfg, dev, args.seed)
    # 7. decode profile, the two attention paths in turns on the same card
    with timed("7 decode profile"):
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
    with timed("9 train"):
        trainer, batches, train_counts, train_res = train(torch, M, cfg, dev, args.seed)
    # 10. one train step, kernels vs plain
    with timed("10 whole step"):
        whole_step(torch, M, cfg, dev, args.seed, trainer.state.params, batches[0])
    # 11. card vs CPU, 3 steps at full width and 2 layers
    with timed("11 card vs cpu"):
        card_vs_cpu(torch, M, smollm_check_path(torch, M, cfg), dev, args.seed)
    # 12. train-step profile
    with timed("12 train profile"):
        train_prof = train_profile(torch, M, trainer, batches)
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()

    # 13-17. CLIP ViT-H/14 (the paper's own model) in the four int8 modes
    clip_cfg = get_config("clip-vit-huge")
    with timed("13-14 CLIP kernels vs plain"):
        clip_worst, n_clip = compare_linear_kernels(torch, M, clip_shapes(clip_cfg), dev,
                                                    args.seed + 23)
        print(f"[kernels] {n_clip} SwitchBack comparisons at CLIP's shapes (every kernel of the "
              "four modes) bit-equal and bit-identical over two launches; max |kernel - plain| "
              + json.dumps(clip_worst))
        clip_flash, n_clip_flash = compare_flash_train(torch, M, clip_flash_cases(clip_cfg), dev,
                                                       args.seed + 29)
        print(f"[kernels] {n_clip_flash} flash comparisons at CLIP's shapes within o "
              f"{json.dumps(FLASH_O_TOL)}, backward {json.dumps(FLASH_BWD_TOL)}; control fault "
              f">= {FAULT_MARGIN:g}x the tolerance: " + json.dumps(clip_flash))
    with timed("15 CLIP train"):
        clip_res, clip_counts = clip_train(torch, M, clip_cfg, dev, args.seed)
    with timed("16 CLIP whole step"):
        clip_whole_step(torch, M, clip_cfg, dev, args.seed)
    with timed("17 CLIP card vs cpu"):
        card_vs_cpu(torch, M, clip_check_path(torch, clip_cfg), dev, args.seed)
    torch.cuda.empty_cache()

    # 19-20. CLIP ViT-H/14 in the four fp8 modes, on the fp8 kernels
    with timed("19 fp8 kernels vs plain"):
        fp8_worst, fp8_mixed, n_fp8 = compare_fp8_kernels(torch, M, clip_shapes(clip_cfg), dev,
                                                          args.seed + 41)
        print(f"[kernels] {n_fp8} fp8 comparisons at CLIP's shapes: quantizers and "
              f"fp8_matmul_dequant bit-equal, fp8_mixed_matmul within {MIXED_TOL} "
              f"(share of outputs off, ulps), each bit-identical over two launches; "
              f"mixed {json.dumps(fp8_mixed)}; max |kernel - plain| " + json.dumps(fp8_worst))
    with timed("20 CLIP fp8 train"):
        fp8_res, fp8_counts = clip_train(torch, M, clip_cfg, dev, args.seed, CLIP_FP8_MODES,
                                         tag="clip fp8 train")
    torch.cuda.empty_cache()

    # 8. timing
    with timed("8 timing"):
        rows = {}
        for R in (PREFILL_ROWS, DECODE_ROWS):
            rows[R] = time_kernels(torch, KOPS, REF, cfg, dev, args.seed, R)
        flash_t = time_flash(torch, M, cfg, dev, args.seed, served_lens)
        print("[timing] flash:", json.dumps(flash_t))
        train_t = time_train_kernels(torch, M, cfg, dev, args.seed)
    with timed("18 CLIP timing"):
        clip_t = time_clip_kernels(torch, M, clip_cfg, dev, args.seed)
    with timed("23 fp8 timing"):
        fp8_t = time_fp8_kernels(torch, M, clip_cfg, dev, args.seed)
    torch.cuda.empty_cache()
    # 21-22. the fp8 whole step, kernels vs plain, and card vs CPU
    with timed("21 CLIP fp8 whole step"):
        clip_whole_step(torch, M, clip_cfg, dev, args.seed, FP8_KERNEL_MODES, CLIP_FP8_STEP_TOL,
                        tag="clip fp8 whole step")
    with timed("22 CLIP fp8 card vs cpu"):
        # phase 17's limits (the fp8 readings in PERF.md lie inside them)
        card_vs_cpu(torch, M, clip_check_path(torch, clip_cfg, FP8_KERNEL_MODES,
                                              tag="clip fp8 card vs cpu", seed_offset=13),
                    dev, args.seed)
    calls = stats["decode_steps"] + stats["prefill_calls"]
    per_train_step = train_res["launches_per_step"]
    # each kernel's largest |kernel - plain| over every phase that held it
    readings = (worst, train_worst, clip_worst,
                *({k: v["max_abs_err"] for k, v in d.items()}
                  for d in (flash_worst, bwd_worst, clip_flash)))
    max_err = {k: max(d.get(k, 0.0) for d in readings) for k in SOURCE}

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
            e = entry(name, r, max_err[name])
            e.update(rows=R, work=f"one layer's {r['calls']} call(s) at {R} rows")
            if "library_rows" in r:
                e["library_rows"] = r["library_rows"]
            out.append(e)
        return out

    full = flash_t["decode_fwd_full"]
    flash_entries = [
        dict(entry("flash_fwd", flash_t["flash_fwd"], max_err["flash_fwd"]),
             library="scaled_dot_product_attention(is_causal=True, enable_gqa=True)"),
        dict(entry("decode_fwd", flash_t["decode_fwd_served"], max_err["decode_fwd"]),
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
    train_entries = [train_entry(k, max_err[k]) for k in (
        "fused_switchback_dgrad", "int8_matmul_dequant_t", "flash_bwd_dq", "flash_bwd_dkv")]
    def clip_entry(name):
        """A kernel of the CLIP path only: ``launches`` summed over the four
        modes' timed runs (CLIP_STEPS steps each), per step by mode beside."""
        r = clip_t[name]
        b_ms, b_by = r["bound"]
        return dict(name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
                    launches=sum(c[name] for c in clip_counts.values()),
                    launches_per_clip_step={m: c[name] / CLIP_STEPS
                                            for m, c in clip_counts.items()},
                    max_abs_err=max_err[name], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=b_ms, bound_by=b_by, library_ms=r["library_ms"],
                    eager_ms=r["eager_ms"], calls_timed=r["calls"], work=r["work"],
                    **({"library": "torch._int_mm + rank-1 scale"} if r["library_ms"] else {}))

    clip_entries = [clip_entry(k) for k in ("col_quantize", "int8_matmul_dequant_colscale",
                                            "int8_matmul_dequant_colscale_t")]

    def fp8_entry(name):
        """An fp8 kernel: ``launches`` summed over the four fp8 modes' timed
        runs (CLIP_STEPS steps each), per step by mode beside."""
        r = fp8_t[name]
        b_ms, b_by = r["bound"]
        return dict(name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
                    launches=sum(c[name] for c in fp8_counts.values()),
                    launches_per_clip_step={m: c[name] / CLIP_STEPS
                                            for m, c in fp8_counts.items()},
                    max_abs_err=fp8_worst[name], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=b_ms, bound_by=b_by, library_ms=r["library_ms"],
                    eager_ms=r["eager_ms"], calls_timed=r["calls"], work=r["work"],
                    **({"library": r["library"]} if r["library"] else {}))

    fp8_entries = [fp8_entry(k) for k in FP8_KERNELS]
    print("[clip train] step: " + json.dumps({
        m: {**{k: r[k] for k in ("step_ms", "pairs_per_s", "peak_memory_gib")},
            **{k: r["profile"][k] for k in ("device_ms_per_step", "device_idle_share",
                                            "cuda_launches_per_step")}}
        for m, r in {**clip_res, **fp8_res}.items()}))
    print("[train] step: " + json.dumps({
        "step_ms_trainer": train_res["step_ms"], "tokens_per_s_trainer": train_res["tokens_per_s"],
        **{k: train_prof[k] for k in ("step_ms", "tokens_per_s", "device_ms_per_step",
                                      "device_idle_share", "cuda_launches_per_step")}}))
    print("[time] phases (s): " + json.dumps(secs))
    print(f"[done] {calls} model calls on the serve path, "
          f"{len(train_res['losses'])} train steps, {len(CLIP_MODES) + len(CLIP_FP8_MODES)} x "
          f"{1 + CLIP_STEPS} CLIP train steps; total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": entries(DECODE_ROWS) + flash_entries + train_entries
                      + clip_entries + fp8_entries}))
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
