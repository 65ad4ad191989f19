#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure:

1. environment: the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, the TF32 flags (both left False);
2. build: compile the SwitchBack kernels (``csrc/switchback.cu``) from
   this checkout with nvcc;
3. kernels vs plain: each kernel bit-equal to its plain PyTorch version
   on the card, at the serve path's shapes (decode rows 8, prefill rows
   1024, K in {960, 2560}, M in {320, 960, 2560}) plus exact half-way ties
   and an all-zero row;
4. serve: full-width smollm-360m (32 layers, d 960, vocab 49152; random
   weights from a seeded torch.Generator) through the ring-cache
   ``ServeEngine`` with ``quant_mode="int8_switchback"`` and
   ``attn_impl="dense"``: a warm-up, then a timed ``generate`` of 16
   requests (prompts of 32-96 tokens, 32 new tokens). Every kernel's
   launch counter is zeroed just before the timed run and must be
   exactly what the run's prefill and decode calls imply just after;
5. whole model, kernels vs plain: the served engine's logits (prefill
   plus three decode steps) with the kernels and with the plain versions
   swapped in on the card, bit-equal;
6. reference: the same engine at full width and two layers on the card
   and on the CPU (plain versions, which the CPU tests hold against the
   JAX package), prefill plus three decode steps: card kernels bit-equal
   to card plain, card within stated tolerances of the CPU, and a control
   fault on the CPU (KV heads tiled instead of repeated) outside them;
7. decode profile: one decode step's wall time, its kernel launches
   (counted over ten steps, each kernel exactly its per-layer count times
   the layers) and its device time by kernel (torch.profiler), at the
   serve run's batch;
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
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (dense): HBM bandwidth, int8 tensor-core ops,
# f32 ops outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12

SOURCE = "src/repro_torch/kernels/switchback/csrc/switchback.cu"
REPLACES = {
    "tensor_quantize": "src/repro/kernels/switchback/switchback.py:124",
    "fused_switchback_fwd": "src/repro/kernels/switchback/switchback.py:269",
    "row_quantize": "src/repro/kernels/switchback/switchback.py:44",
    "int8_matmul_dequant": "src/repro/kernels/switchback/switchback.py:197",
}
# launches per layer per model call (prefill or decode step): every
# linear quantizes its weight; wq, wk, wv, wo, w_up, w_gate contract over
# K = 960 <= 2048 (fused); w_down over K = 2560 (row_quantize + matmul)
PER_LAYER = {"tensor_quantize": 7, "fused_switchback_fwd": 6,
             "row_quantize": 1, "int8_matmul_dequant": 1}

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


def bound(bytes_, int8_ops=0.0, f32_ops=0.0):
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = int8_ops / INT8_OPS_PER_S + f32_ops / F32_OPS_PER_S
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


# ---------------------------------------------------------------------------
# phases 4-6: the serve path
# ---------------------------------------------------------------------------

def serve(torch, KOPS, cfg, dev, seed):
    import numpy as np

    from repro_torch.configs.base import ParallelConfig, ServeConfig
    from repro_torch.serve import make_serve_engine

    scfg = ServeConfig(max_batch=8, max_len=256, quant_mode="int8_switchback")
    t = time.perf_counter()
    eng = make_serve_engine("smollm-360m", scfg,
                            parallel=ParallelConfig(attn_impl="dense"),
                            device=dev)
    params = eng.init_params(seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"[serve] engine + {n_params / 1e6:.1f} M params on {dev} in "
          f"{time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(seed)
    lens = rng.integers(32, 97, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in lens]
    eng.generate(params, prompts, max_new_tokens=2)              # warm-up

    torch.cuda.reset_peak_memory_stats()
    KOPS.reset_launch_counts()
    gens, stats = eng.generate(params, prompts, max_new_tokens=32)
    counts = KOPS.launch_counts()

    check(len(gens) == len(prompts) and all(len(g) == 32 for g in gens),
          f"not every request got 32 tokens: {[len(g) for g in gens]}")
    check(all(0 <= t < cfg.vocab_size for g in gens for t in g),
          "a token outside the vocabulary")
    calls = stats["decode_steps"] + stats["prefill_calls"]
    for k, per in PER_LAYER.items():
        check(counts[k] > 0, f"{k} never launched on the serve path")
        check(counts[k] == per * cfg.n_layers * calls,
              f"{k}: {counts[k]} launches, expected {per} x {cfg.n_layers} "
              f"layers x {calls} model calls")
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
def plain_ops(KOPS, REF):
    """Send the model's kernel calls to their plain versions, for the
    whole-model kernels-vs-plain check only (the package has no such
    switch: its wrappers launch the kernel on a CUDA tensor or raise)."""
    saved = {name: getattr(KOPS, name) for name in PER_LAYER}
    for name in PER_LAYER:
        setattr(KOPS, name, getattr(REF, name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(KOPS, name, fn)


@contextlib.contextmanager
def tiled_kv_heads():
    """The control fault: GQA expansion by tiling the KV heads (0,1,2,0,1,2)
    where the model repeats each (0,0,1,1,2,2), a one-word wiring slip."""
    from repro_torch.models import attention as A
    saved = A._expand_kv
    A._expand_kv = lambda k, n_heads: k.repeat(1, 1, n_heads // k.shape[2], 1)
    try:
        yield
    finally:
        A._expand_kv = saved


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


def prompt_batch(prompts, B, S):
    import numpy as np
    toks = np.zeros((B, S), np.int64)
    lens = np.zeros((B,), np.int32)
    for b in range(B):
        p = prompts[b][:S]
        toks[b, :len(p)] = p
        lens[b] = len(p)
    return toks, lens


def whole_model_bitwise(torch, KOPS, REF, eng, params, prompts):
    """The served engine (full depth, bf16 compute) with the kernels and
    with the plain versions swapped in: logits bit-equal at every call."""
    toks, lens = prompt_batch(prompts, eng.serve_cfg.max_batch, 128)
    kern, fed = run_logits(eng, params, toks, lens)
    with plain_ops(KOPS, REF):
        plain, _ = run_logits(eng, params, toks, lens, fed)
    diffs = [max_abs_diff(torch, a, b) for a, b in zip(kern, plain)]
    check(all(torch.equal(a, b) for a, b in zip(kern, plain)),
          f"served model: kernel logits != plain logits (max |diff| per call {diffs})")
    check(all(bool(torch.isfinite(a).all()) for a in kern), "non-finite served logits")
    print(f"[whole model] prefill + 3 decode steps, {len(lens)} slots, "
          f"{eng.cfg.n_layers} layers: kernel logits bit-equal to plain")


def reference(torch, KOPS, REF, cfg, dev, seed):
    """Full width, two layers, prefill + 3 decode steps on the same weights
    and tokens: card kernels against card plain (bit-equal), card against
    the CPU's plain path (within tolerance), and a control fault on the
    CPU against the CPU (outside the tolerance)."""
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
    # Tolerances (max, mean), relative to max|logit|. Card and CPU differ
    # in the order of sums in the attention and head products and in libm
    # ulps; the int8 quantizers amplify such last-bit differences in f32,
    # where an activation on the other side of a rounding boundary moves its
    # row's product by one quantization step. bf16 absorbs most of them.
    # The control fault (KV heads tiled) must land outside both bounds.
    tolerances = {torch.float32: (5e-2, 5e-3), torch.bfloat16: (2e-2, 1e-4)}

    def rel_errs(got, want):
        return (max(float((a.float().cpu() - b.float()).abs().max() / b.float().abs().max())
                    for a, b in zip(got, want)),
                max(float((a.float().cpu() - b.float()).abs().mean() / b.float().abs().max())
                    for a, b in zip(got, want)))

    res = {}
    for cd, tol in tolerances.items():
        name = str(cd).replace("torch.", "")

        def engine(where):
            return make_serve_engine(
                small, ServeConfig(max_batch=B, max_len=128, quant_mode="int8_switchback"),
                parallel=ParallelConfig(attn_impl="dense"),
                policy=QuantPolicy("int8_switchback", compute_dtype=cd), device=where)

        cpu_eng, dev_eng = engine("cpu"), engine(dev)
        cpu, fed = run_logits(cpu_eng, params_cpu, toks, lens)   # fed to every run
        with tiled_kv_heads():
            fault, _ = run_logits(cpu_eng, params_cpu, toks, lens, fed)
        card, _ = run_logits(dev_eng, params_dev, toks, lens, fed)
        with plain_ops(KOPS, REF):
            card_plain, _ = run_logits(dev_eng, params_dev, toks, lens, fed)
        bitwise = all(torch.equal(a, b) for a, b in zip(card, card_plain))
        rel, mean = rel_errs(card, cpu)
        f_rel, f_mean = rel_errs(fault, cpu)
        agree = float(np.mean([float((a.cpu().argmax(-1) == b.argmax(-1)).float().mean())
                               for a, b in zip(card, cpu)]))
        res[name] = dict(card_kernels_eq_card_plain=bitwise, max_rel_err=rel,
                         mean_rel_err=mean, tolerance=tol, argmax_agree=agree,
                         control_fault_max_rel_err=f_rel,
                         control_fault_mean_rel_err=f_mean)
        check(all(bool(torch.isfinite(a).all()) and tuple(a.shape) == (B, cfg.vocab_size)
                  for a in card), f"reference {name}: non-finite or misshapen logits")
        check(bitwise, f"reference {name}: card kernel logits != card plain logits")
        check(rel <= tol[0] and mean <= tol[1],
              f"reference {name}: card vs CPU max/mean rel err {rel:g}/{mean:g} "
              f"> {tol[0]:g}/{tol[1]:g}")
        check(f_rel > tol[0] and f_mean > tol[1],
              f"reference {name}: the control fault ({f_rel:g}/{f_mean:g}) lies within "
              f"the tolerance {tol[0]:g}/{tol[1]:g}, which so could not see it")
    print("[reference]", json.dumps(res))
    return res


def decode_profile(torch, KOPS, cfg, eng, params, prompts):
    """Wall time and kernel launches of one full-batch decode step over 10
    steps, and the device time by kernel over 5 (torch.profiler)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    B = eng.serve_cfg.max_batch
    cache = eng.init_cache()
    toks, lens = prompt_batch(prompts, B, 128)
    lg, cache = eng.prefill(params, cache, toks, lens, np.ones((B,), bool))
    cur = lg[:, 0].argmax(-1).cpu().numpy()[:, None]
    for _ in range(3):
        lg, cache = eng.decode(params, cache, cur)
    torch.cuda.synchronize()
    n = 10
    KOPS.reset_launch_counts()
    t = time.perf_counter()
    for _ in range(n):
        lg, cache = eng.decode(params, cache, cur)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / n * 1e3
    per_step = {k: v / n for k, v in KOPS.launch_counts().items()}
    for k, per in PER_LAYER.items():
        check(per_step[k] == per * cfg.n_layers,
              f"{k}: {per_step[k]} launches per decode step, expected {per} x "
              f"{cfg.n_layers} layers")

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
            by_kernel[e.key] = (us / n_prof / 1e3, e.count // n_prof)
    dev_ms = sum(v[0] for v in by_kernel.values())
    groups = {}
    for key, (ms, cnt) in by_kernel.items():
        g = next((k for k in ("row_quantize", "absmax_partial", "cast_tensorwise",
                              "fused_fwd", "int8_matmul_dequant") if k in key), None)
        g = g or ("gemm" if "gemm" in key.lower() or "sm90" in key.lower() else "other")
        a = groups.setdefault(g, [0.0, 0])
        a[0] += ms
        a[1] += cnt
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    prof_out = dict(
        step_ms=step_ms, launches_per_step=per_step, device_ms_per_step=dev_ms,
        device_idle_share=(max(0.0, 1 - dev_ms / step_ms) if dev_ms else None),
        groups={g: {"ms": v[0], "launches": v[1]} for g, v in
                sorted(groups.items(), key=lambda kv: -kv[1][0])},
        top=[{"kernel": k[:90], "ms": v[0], "launches": v[1]} for k, v in top])
    if not dev_ms:
        print("[profile] torch.profiler saw no device time; step wall time only")
    print("[profile]", json.dumps(prof_out))
    return prof_out


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
    from repro_torch.kernels.switchback import build as KB
    from repro_torch.kernels.switchback import ops as KOPS
    from repro_torch.kernels.switchback import ref as REF

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

    # 2. build
    t = time.perf_counter()
    lib_path, log = KB.build()
    KB.load()
    build_s = time.perf_counter() - t
    print(f"[build] {os.path.relpath(lib_path, ROOT)} in {build_s:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("[build]", line.strip())

    cfg = get_config("smollm-360m")
    # 3. kernels vs plain
    worst, n_cmp = compare_kernels(torch, KOPS, REF, cfg, dev, args.seed)
    print(f"[kernels] {n_cmp} comparisons bit-equal; max |kernel - plain| "
          + json.dumps(worst))

    # 4. serve (the main path)
    eng, params, prompts, stats, counts = serve(torch, KOPS, cfg, dev, args.seed)
    # 5. whole model, kernels vs plain
    whole_model_bitwise(torch, KOPS, REF, eng, params, prompts)
    # 6. reference
    reference(torch, KOPS, REF, cfg, dev, args.seed)
    # 7. decode profile
    prof = decode_profile(torch, KOPS, cfg, eng, params, prompts)
    del eng, params
    torch.cuda.empty_cache()

    # 8. timing
    rows = {}
    for R in (PREFILL_ROWS, DECODE_ROWS):
        rows[R] = time_kernels(torch, KOPS, REF, cfg, dev, args.seed, R)
    calls = stats["decode_steps"] + stats["prefill_calls"]

    def entries(R):
        out = []
        for name, r in rows[R].items():
            b_ms, b_by = r["bound"]
            e = dict(name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
                     launches=counts[name],
                     launches_per_decode_step=prof["launches_per_step"][name],
                     max_abs_err=worst[name],
                     ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b_ms,
                     bound_by=b_by, library_ms=r["library_ms"], eager_ms=r["eager_ms"],
                     rows=R, calls_timed=r["calls"],
                     work=f"one layer's {r['calls']} call(s) at {R} rows")
            if "library_rows" in r:
                e["library_rows"] = r["library_rows"]
            out.append(e)
        return out

    print(json.dumps({"kernels_prefill": entries(PREFILL_ROWS)}))
    print(f"[done] {calls} model calls on the serve path; "
          f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": entries(DECODE_ROWS)}))
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
