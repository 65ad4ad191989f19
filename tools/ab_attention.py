#!/usr/bin/env python3
"""The attention kernels of one checkout of the port, read on one card.

    python3 tools/ab_attention.py [--src DIR] [--tag NAME] [--out FILE]

Loads ``repro_torch`` from ``DIR`` (default: this checkout's ``src``; give
the ``src`` of an unpacked older commit to read its kernels), builds its
flash-attention and paged-attention libraries there, and runs
``chip_smoke.py``'s checks and timings of those kernels from this
checkout, so that two commits are read by the same code on the same card:

* phase 24 (``compare_paged``): both paged kernels against their plain
  versions, with the mean signed error of o by q's dtype, and every
  prefill row bit-equal to the decode at its position; their times
  (``time_paged``);
* phase 3 (``compare_flash``): ``flash_fwd`` and ``decode_fwd`` against
  their plain versions at the serve path's shapes and edges;
* phases 3 and 14 (``compare_flash_train``): ``flash_fwd`` and the two
  backward kernels against their plain versions at smollm's and CLIP's
  training shapes, with ``flash_fwd``'s mean signed error of o and lse;
* ``narrow_digests``: SHA-256 of ``decode_fwd``'s outputs at query groups
  1-8 and the paged kernels' at 1-16 (the groups both took before their
  wide forms): two checkouts that print the same digests give those
  groups the same bits;
* the flash kernels' times: ``flash_fwd`` at the 1,024-row prefill and
  ``decode_fwd`` at 8 slots of a 256-cell cache, full and at 200 each
  (``time_flash``), ``flash_fwd`` at 8 x 256, the backward pair at 8 x
  256 (``time_flash_bwd``, SDPA's backward beside), all three at CLIP's
  two shapes (``time_clip_flash``).

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
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "ab_attention.jsonl"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ab_attention: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    sys.path.insert(0, os.path.abspath(args.src))       # before chip_smoke's own src
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import build as FB
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FREF
    from repro_torch.kernels.fp8_matmul import ops as F8
    from repro_torch.kernels.fp8_matmul import ref as F8REF
    from repro_torch.kernels.paged_attention import build as PAB
    from repro_torch.kernels.paged_attention import ops as PA
    from repro_torch.kernels.paged_attention import ref as PREF
    from repro_torch.kernels.switchback import ops as KOPS
    from repro_torch.kernels.switchback import ref as REF
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    if src != os.path.abspath(args.src):
        print(f"ab_attention: repro_torch came from {src}, not {args.src}", file=sys.stderr)
        return 1
    M = types.SimpleNamespace(KOPS=KOPS, REF=REF, FA=FA, FREF=FREF, F8=F8, F8REF=F8REF, PA=PA,
                              PREF=PREF)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = C.nvidia_smi_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    for mod in (FB, PAB):
        mod.build()
        mod.load()
    res = dict(tag=args.tag, src=os.path.relpath(src, ROOT), card=smi,
               build_s=time.perf_counter() - t0)
    cfg, clip_cfg = get_config("smollm-360m"), get_config("clip-vit-huge")
    try:
        paged, n_paged, n_rows = C.compare_paged(torch, M, cfg, dev, args.seed)
        res["paged"] = dict(readings=paged, comparisons=n_paged, rows_bit_equal=n_rows,
                            times=C.time_paged(torch, M, cfg, dev, args.seed))
        flash = {}
        for name, cases, off in (("smollm", C.smollm_flash_cases(cfg), 17),
                                 ("clip", C.clip_flash_cases(clip_cfg), 29)):
            flash[name], _ = C.compare_flash_train(torch, M, cases, dev, args.seed + off)
        res["flash"] = flash
        res["ring"], _ = C.compare_flash(torch, M, cfg, dev, args.seed)
        res["digests"] = C.narrow_digests(torch, M, dev, args.seed)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 19)
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        bwd, asets = C.time_flash_bwd(torch, M, gen, dev, C.TRAIN_BATCH, C.TRAIN_SEQ, H, KV, hd,
                                      True)
        fwd = lambda i: FA.flash_fwd_lse(*asets[i][:3], causal=True)
        ring = C.time_flash(torch, M, cfg, dev, args.seed, [200] * 8)
        times = {"flash_fwd 8 x 256": dict(ms=C.graph_ms(torch, fwd, len(asets))),
                 "flash_fwd prefill 8 x 128": ring["flash_fwd"],
                 "decode_fwd 8 x 256 full": ring["decode_fwd_full"],
                 "decode_fwd 8 x 256 at 200": ring["decode_fwd_served"],
                 **{f"{k} 8 x 256": r for k, r in bwd.items()}}
        del asets
        for name, by_tower in C.time_clip_flash(torch, M, clip_cfg, dev, args.seed + 43).items():
            for tower, r in by_tower.items():
                times[f"{name} clip {tower}"] = r
        res["times_ms"] = {k: r["ms"] for k, r in times.items()}
        res["times"] = times
    except C.Failure as e:
        print(f"ab_attention ({args.tag}): FAILED: {e}", file=sys.stderr)
        return 1
    res["seconds"] = time.perf_counter() - t0
    line = json.dumps(res)
    print(f"[ab] {args.tag}: " + json.dumps(dict(
        card=smi, times_ms=res["times_ms"],
        paged={k: {x: r[x] for x in ("max_rel_err", "mean_signed_err")}
               for k, r in paged.items()},
        paged_ms={k: r["ms"] for k, r in res["paged"]["times"].items()},
        flash={t: {k: {x: r[x] for x in ("max_rel_err", "mean_signed_err") if x in r}
                   for k, r in f.items()} for t, f in flash.items()},
        ring={k: r["max_rel_err"] for k, r in res["ring"].items()}, digests=res["digests"],
        seconds=res["seconds"])))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as fh:
        fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
