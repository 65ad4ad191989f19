#!/usr/bin/env python3
"""The int8 row and column quantizers of one checkout of the port, read on one card.

    python3 tools/ab_int8_quantize.py [--src DIR] [--tag NAME] [--out FILE]

Loads ``repro_torch`` from ``DIR`` (default: this checkout's ``src``; give
the ``src`` of an unpacked older commit to read its kernels), builds its
SwitchBack library there, and runs ``chip_smoke.py``'s checks and timings
of ``row_quantize`` and ``col_quantize`` from this checkout, so that two
commits are read by the same code on the same card:

* phase 13's checks: every SwitchBack kernel of the four CLIP modes at
  CLIP's shapes (``compare_linear_kernels``) and the quantizers' edges
  (``compare_int8_quantizer_edges``), bit-equal to their plain versions
  and bit-identical over two launches, the control fault caught;
* ``time_int8_quantizers``: the column-wise modes' calls of one CLIP
  vision layer (4,128 rows: 18 ``row_quantize``, 6 ``col_quantize``), one
  text layer (2,464) and the patch embedding (8,192 x 588), and smollm's
  train layer (2,048 rows: the 3 ``row_quantize`` calls of
  ``int8_switchback``), by graph replay, beside the bound;
  ``time_tensor_quantize``: ``tensor_quantize`` of a decode layer's seven
  weights and of each CLIP tower layer's (6, 6, 1);
* the SASS of the built library (``cuobjdump -sass``, counted as
  ``tools/ab_fp8_quantize.py`` counts it): for each int8 quantizer kernel
  its instructions, and per value those of its loops' bodies or, in a
  kernel without such loops, of its body over the 64 values a thread
  holds; ``per_value`` names the bf16 kernels of the 16-byte path; the
  tensor quantizer's a value as ``ab_fp8_quantize.tensor_sass`` counts it.

Run it for two checkouts in turns (A, B, B, A) within one call to compare
them. Prints one JSON line and appends it to ``--out``. Needs one card;
exits 1 without one, and on any failed check.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

QUANTIZERS = ("row_quantize", "col_quantize", "fused_quantize")


def vector_path(name: str) -> bool:
    """A bf16 kernel of the 16-byte path: the granule template argument 8,
    or none (an older commit's kernels, one form each)."""
    g = re.findall(r"Li(\d+)E", name)
    return "__nv_bfloat16" in name and (not g or g[0] == "8")


def sass_counts(lib_path: str):
    """Per int8 quantizer kernel of the library, its counts; and the
    tensor quantizer's a value (``ab_fp8_quantize.tensor_sass``)."""
    from ab_fp8_quantize import count_kernel, sass_functions, tensor_sass
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    funcs = sass_functions(text)
    return ({name: count_kernel(fn) for name, fn in funcs.items()
             if any(q in name for q in QUANTIZERS)}, tensor_sass(funcs))


def smollm_train_calls(C, cfg, fused_max):
    """``int8_switchback``'s ``row_quantize`` calls of one smollm train
    layer: X of each forward whose K exceeds ``fused_max``, Ẏ of each dgrad
    whose output width does."""
    shapes = C.path_shapes(cfg).values()
    return ([(C.TRAIN_ROWS, K, False) for K, _ in shapes if K > fused_max]
            + [(C.TRAIN_ROWS, Mw, False) for _, Mw in shapes if Mw > fused_max], [])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "ab_int8_quantize.jsonl"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ab_int8_quantize: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    sys.path.insert(0, os.path.abspath(args.src))       # before chip_smoke's own src
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.switchback import build as KB
    from repro_torch.kernels.switchback import ops as KOPS
    from repro_torch.kernels.switchback import ref as REF
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    if src != os.path.abspath(args.src):
        print(f"ab_int8_quantize: repro_torch came from {src}, not {args.src}", file=sys.stderr)
        return 1
    M = types.SimpleNamespace(KOPS=KOPS, REF=REF)
    smi = C.nvidia_smi_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib, log = KB.build()
    KB.load()
    sass, sass_tensor = sass_counts(str(lib))
    res = dict(tag=args.tag, src=os.path.relpath(src, ROOT), card=smi,
               build_s=time.perf_counter() - t0,
               ptxas=[ln.strip() for ln in log.splitlines()
                      if any(q in ln for q in QUANTIZERS)
                      or "registers" in ln or "spill" in ln],
               sass=sass, sass_tensor=sass_tensor)
    cfg, clip_cfg = get_config("smollm-360m"), get_config("clip-vit-huge")
    try:
        worst, n = C.compare_linear_kernels(torch, M, C.clip_shapes(clip_cfg), dev, args.seed + 23)
        qworst, qn, caught = C.compare_int8_quantizer_edges(torch, M, dev, args.seed + 47)
        res["checks"] = dict(clip=dict(comparisons=n, worst=worst),
                             edges=dict(comparisons=qn, worst=qworst, faults_caught=caught))
        gen = torch.Generator(device=dev).manual_seed(args.seed + 31)
        cases = [(tower, C.int8_quantizer_calls(lins, rows))
                 for tower, rows, _, _, _, lins in C.clip_shapes(clip_cfg)]
        cases.append(("smollm train", smollm_train_calls(C, cfg, KOPS.FUSED_MAX_CONTRACT)))
        times = {}
        row = lambda r: {k: r[k] for k in ("ms", "eager_ms", "calls", "work")} | {
            "bound_ms": r["bound"][0], "bound_share": r["bound"][0] / r["ms"]}
        for tower, calls in cases:
            got = C.time_int8_quantizers(torch, M, gen, dev, calls, f"one {tower} layer",
                                         plain=False)
            for kernel, r in got.items():
                times[f"{kernel} {tower}"] = row(r)
        # tensor_quantize of a decode layer's seven weights and of each CLIP
        # tower layer's (int8_switchback and _m)
        weights = [("decode", list(C.path_shapes(cfg).values()))]
        weights += [(tower, C.tower_weights(lins))
                    for tower, _, _, _, _, lins in C.clip_shapes(clip_cfg)]
        for where, shapes in weights:
            times[f"tensor_quantize {where}"] = row(C.time_tensor_quantize(
                torch, KOPS.tensor_quantize, None, gen, dev, shapes, f"one {where} layer"))
        res["times"] = times
    except C.Failure as e:
        print(f"ab_int8_quantize ({args.tag}): FAILED: {e}", file=sys.stderr)
        return 1
    res["seconds"] = time.perf_counter() - t0
    print(f"[ab] {args.tag}: " + json.dumps(dict(
        card=smi, us={k: r["ms"] * 1e3 for k, r in times.items()},
        sass_per_value={**{k: round(v["per_value"], 2) for k, v in sass.items()
                           if vector_path(k)},
                        **{f"tensor_quantize {k}": round(v["per_value"], 2)
                           for k, v in sass_tensor.items()}},
        comparisons=n + qn, seconds=res["seconds"])))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as fh:
        fh.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
