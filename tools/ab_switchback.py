#!/usr/bin/env python3
"""The fused SwitchBack pair of one checkout of the port, read on one card.

    python3 tools/ab_switchback.py [--src DIR] [--tag NAME] [--out FILE]

Loads ``repro_torch`` from ``DIR`` (default: this checkout's ``src``; give
the ``src`` of an unpacked older commit to read its kernels), builds its
SwitchBack library there, and runs ``chip_smoke.py``'s checks and timings
of ``fused_switchback_fwd`` and ``fused_switchback_dgrad`` from this
checkout, so that two commits are read by the same code on the same card:

* phases 3 and 13 (``compare_linear_kernels`` at smollm's train shapes and
  CLIP's, ``compare_int8_edges``): every SwitchBack kernel bit-equal to
  its plain version and bit-identical over two launches;
* ``time_fused``: one layer's fused calls by graph replay beside the
  port's two-step path at the same calls (``row_quantize`` then
  ``int8_matmul_dequant`` or ``_t``) and the bound: smollm's forward at
  decode (8 rows) and prefill (1,024), both at training (2,048); CLIP's
  vision (4,128) and text (2,464) layers and the patch embedding (8,192 x
  588 -> 1,280).

Run it for two checkouts in turns (A, B, B, A) within one call to compare
them. Prints one JSON line and appends it to ``--out``. Needs one card;
exits 1 without one, and on any failed check.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "ab_switchback.jsonl"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ab_switchback: no CUDA device", file=sys.stderr)
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
        print(f"ab_switchback: repro_torch came from {src}, not {args.src}", file=sys.stderr)
        return 1
    M = types.SimpleNamespace(KOPS=KOPS, REF=REF)
    smi = C.nvidia_smi_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _, log = KB.build()
    KB.load()
    res = dict(tag=args.tag, src=os.path.relpath(src, ROOT), card=smi,
               build_s=time.perf_counter() - t0,
               ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln])
    cfg, clip_cfg = get_config("smollm-360m"), get_config("clip-vit-huge")
    fused_max = KOPS.FUSED_MAX_CONTRACT
    smollm = [(K, Mw, True) for K, Mw in C.path_shapes(cfg).values()]
    cases = [("decode", C.DECODE_ROWS, smollm, False), ("prefill", C.PREFILL_ROWS, smollm, False),
             ("train", C.TRAIN_ROWS, smollm, True)]
    cases += [(f"clip {tower}", rows, C.clip_layer(lins), True)
              for tower, rows, _, _, _, lins in C.clip_shapes(clip_cfg)]
    try:
        checks = {}
        for name, table, off in (("smollm", C.smollm_train_shapes(cfg), 13),
                                 ("clip", C.clip_shapes(clip_cfg), 23)):
            worst, n = C.compare_linear_kernels(torch, M, table, dev, args.seed + off)
            checks[name] = dict(comparisons=n, worst=worst)
        worst, n = C.compare_int8_edges(torch, M, dev, args.seed + 37)
        checks["edges"] = dict(comparisons=n, worst=worst)
        res["checks"] = checks
        gen = torch.Generator(device=dev).manual_seed(args.seed + 31)
        times = {}
        for name, rows, linears, dgrad in cases:
            fwd, dg = C.fused_calls(linears, fused_max)
            got = C.time_fused(torch, M, gen, dev, rows, fwd, dg if dgrad else [],
                               lambda c, n=name, r=rows: f"{n}: one layer's {c} calls at {r} rows",
                               plain=False)
            for kernel, r in got.items():
                times[f"{kernel} {name}"] = {k: r[k] for k in (
                    "ms", "two_step_ms", "eager_ms", "tops", "bound_share", "calls", "work")
                    } | {"bound_ms": r["bound"][0]}
        res["times"] = times
    except C.Failure as e:
        print(f"ab_switchback ({args.tag}): FAILED: {e}", file=sys.stderr)
        return 1
    res["seconds"] = time.perf_counter() - t0
    print(f"[ab] {args.tag}: " + json.dumps(dict(
        card=smi, ms={k: r["ms"] for k, r in times.items()},
        two_step_ms={k: r["two_step_ms"] for k, r in times.items()},
        comparisons={k: c["comparisons"] for k, c in checks.items()},
        seconds=res["seconds"])))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as fh:
        fh.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
