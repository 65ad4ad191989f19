#!/usr/bin/env python3
"""How far apart the card and the CPU land in ``chip_smoke.py`` phase 22.

    python3 tools/gate_seeds.py [--seeds 8]

Phase 22 trains CLIP ViT-H/14 at 2 + 2 layers and full width for 3 steps
in the fp8 modes (``fp8`` and ``fp8_mixed`` in turn) from 3 seeds, on the
card and on the CPU, and holds every seed's loss trajectory within 1% and
its parameters within 0.4% (``CLIP_CARD_CPU_TOL``), with a control fault
(the positional embedding read a row off) outside. This runs the same
comparison (``chip_smoke.card_vs_cpu``, the same seeds and then more) twice:
with the kernels on the card, and with ``flash_fwd``'s plain version (the
CPU's algorithm) in place of its kernel. It prints every seed's readings
and how many exceed the limits, and fails on nothing: it reads the gate's
own spread, it is not a gate. Needs one card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
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
    M = types.SimpleNamespace(KOPS=KOPS, REF=REF, FA=FA, FREF=FREF, F8=F8, F8REF=F8REF, PA=PA,
                              PREF=PREF, FC=FC)
    # phase 1's settings: full-precision products, as the JAX package's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(C.nvidia_smi_line())
    dev = torch.device("cuda", 0)
    cfg = get_config("clip-vit-huge")
    C.CHECK_SEEDS = args.seeds
    C.check = lambda ok, what: None            # read, never fail
    variants = {"kernels": contextlib.nullcontext,
                "plain flash_fwd": lambda: C.swapped([(FA, "flash_fwd_lse",
                                                       C.plain_flash_fwd(M))])}
    tol = C.CLIP_CARD_CPU_TOL
    summary = {}
    for name, ctx in variants.items():
        with ctx():
            res = C.card_vs_cpu(torch, M, C.clip_check_path(
                torch, cfg, C.FP8_KERNEL_MODES, tag=f"gate seeds, {name}", seed_offset=13),
                dev, args.seed)
        loss = [r["loss_rel_err"] for r in res.values()]
        fault = [r["fault_loss_rel_err"] for r in res.values()]
        summary[name] = dict(
            seeds=len(res), over_limit=sum(any(r[k] > t for k, t in tol.items())
                                           for r in res.values()),
            loss_rel_err_mean=statistics.mean(loss), loss_rel_err_max=max(loss),
            fault_loss_rel_err_min=min(fault),
            loss_rel_err_by_seed={k: r["loss_rel_err"] for k, r in res.items()})
    print("[gate seeds] limits " + json.dumps(tol) + ": " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
