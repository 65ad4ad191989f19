#!/usr/bin/env python3
"""Candidate statistics for ``chip_smoke.py`` phase 22's gate, over many seeds.

    python3 tools/gate_seeds.py [--seeds 16] [--out runs/gate_seeds.json]

Phase 22 trains CLIP ViT-H/14 at 2 + 2 layers and full width for 3 steps
in the fp8 modes (``fp8`` and ``fp8_mixed`` in turn) on the card and on
the CPU from the same parameters, batches and kept patches, and holds the
two together (``chip_smoke.card_vs_cpu``). This reads, at the seeds
``card_vs_cpu`` derives with CHECK_SEEDS raised to ``--seeds``, what each
candidate statistic of ``chip_smoke.run_errs`` reads (the loss over every
step, the loss over the steps before the third, the final parameters'
worst per-leaf mean) for sound runs and for the three control faults of
``chip_smoke.clip_faults``:

* against the CPU (its plain versions): the card with its kernels, with
  the plain flash forward in place of its kernel, with the three flash
  training kernels' plain versions, and with every kernel's
  (``plain_ops``); the faults as phase 22 runs them (the positional
  embedding rolled on the card; the fp8 matmuls' slab fault and the text
  tower's mask dropped patched into the CPU's plain versions);
* on one device: the card's kernels (and the plain-flash variants)
  against the card's plain versions, each fault patched into the card's
  plain versions.

For each statistic it prints the worst sound reading, each fault's
smallest, the limit phase 10's rule gives (the geometric mean of the two,
one digit) and how many readings fall on the wrong side of it. It fails on
nothing: it reads the gate, it is not one. Every reading goes to
``--out``. Needs one card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KEYS = ("loss_rel_err", "early_loss_rel_err", "param_mean_rel_err")


def summarise(readings, where, sound, faults):
    """Per statistic: the worst sound reading by variant, the smallest
    reading by fault, the limit by phase 10's rule and the readings on the
    wrong side of it."""
    out = {}
    for key in KEYS:
        worst = {n: max(r[where][n][key] for r in readings.values()) for n in sound}
        least = {n: min(r[where][n][key] for r in readings.values()) for n in faults}
        hi, lo = max(worst.values()), min(least.values())
        limit = float(f"{math.sqrt(hi * lo):.0e}")
        out[key] = dict(sound_max=worst, fault_min=least, separation=lo / hi, limit=limit,
                        sound_over_limit=sum(r[where][n][key] > limit
                                             for r in readings.values() for n in sound),
                        faults_within_limit=sum(r[where][n][key] <= limit
                                                for r in readings.values() for n in faults))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "gate_seeds.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gate_seeds: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FREF
    from repro_torch.kernels.fp8_cast import ops as FC
    from repro_torch.kernels.fp8_matmul import ops as F8
    from repro_torch.kernels.fp8_matmul import ref as F8REF
    from repro_torch.kernels.paged_attention import ops as PA
    from repro_torch.kernels.paged_attention import ref as PREF
    from repro_torch.kernels.switchback import ops as KOPS
    from repro_torch.kernels.switchback import ref as REF
    from repro_torch.models import params as PRM
    M = types.SimpleNamespace(KOPS=KOPS, REF=REF, FA=FA, FREF=FREF, F8=F8, F8REF=F8REF, PA=PA,
                              PREF=PREF, FC=FC)
    # phase 1's settings: full-precision products, as the JAX package's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = C.nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    C.CHECK_SEEDS = args.seeds
    path = C.clip_check_path(torch, M, get_config("clip-vit-huge"), C.FP8_KERNEL_MODES,
                             tag="gate seeds", seed_offset=13, faults=C.CLIP_FP8_FAULTS)
    flash_plain = [(FA, "flash_fwd_lse", C.plain_flash_fwd(M)),
                   (FA, "flash_bwd_dq", C.plain_flash_bwd(M, "flash_bwd_dq")),
                   (FA, "flash_bwd_dkv", C.plain_flash_bwd(M, "flash_bwd_dkv"))]
    variants = {"kernels": contextlib.nullcontext,
                "plain flash_fwd": lambda: C.swapped(flash_plain[:1]),
                "plain flash": lambda: C.swapped(flash_plain),
                "all plain": lambda: C.plain_ops(M, flash=True)}
    on_card = ("kernels", "plain flash_fwd", "plain flash")
    readings = {}
    for j, s in enumerate(C.check_seeds(args.seed, path.seed_offset)):
        mode = path.modes[j % len(path.modes)]
        p0 = PRM.init_params(C.param_specs_of(path.small), s, device="cpu")
        batches, keeps = path.batches(3, "cpu", s), path.keeps(3, s)

        def run(where, fault=None):
            return C.path_run(torch, path, where, mode, p0, batches, keeps, fault)

        cpu = run("cpu")
        card = {}
        for name, ctx in variants.items():
            with ctx():
                card[name] = run(dev)
        r = {"losses_cpu": cpu[0], "vs_cpu": {}, "on_card": {}}
        for name, got in card.items():
            r["vs_cpu"][name] = dict(losses=got[0], **C.run_errs(got, cpu, p0))
        for name, f in path.faults.items():
            got = run(f.where or dev, f)
            r["vs_cpu"][name] = dict(losses=got[0], **C.run_errs(got, cpu, p0))
        plain = card["all plain"]
        for name in on_card:
            r["on_card"][name] = C.run_errs(card[name], plain, p0)
        with C.plain_ops(M, flash=True):
            for name, f in path.faults.items():
                r["on_card"][name] = C.run_errs(run(dev, f), plain, p0)
        readings[f"{mode}_seed{s}"] = r
        print(f"[gate seeds] {mode}_seed{s} ({time.perf_counter() - t0:.0f} s): "
              + json.dumps({w: {n: [round(x[k], 7) for k in KEYS] for n, x in r[w].items()}
                            for w in ("vs_cpu", "on_card")}), flush=True)
    faults = list(path.faults)
    summary = {"vs_cpu": summarise(readings, "vs_cpu", list(variants), faults),
               "on_card": summarise(readings, "on_card", on_card, faults)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(dict(card=smi, seeds=args.seeds, keys=KEYS, readings=readings,
                       summary=summary), fh, indent=1)
    print(f"[gate seeds] {args.seeds} seeds in {time.perf_counter() - t0:.0f} s; readings in "
          f"{os.path.relpath(args.out, ROOT)}")
    print("[gate seeds] summary " + json.dumps(summary))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
