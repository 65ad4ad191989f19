#!/usr/bin/env python3
"""The fp8 quantizers of one checkout of the port, read on one card.

    python3 tools/ab_fp8_quantize.py [--src DIR] [--tag NAME] [--out FILE]

Loads ``repro_torch`` from ``DIR`` (default: this checkout's ``src``; give
the ``src`` of an unpacked older commit to read its kernels), builds its
fp8 library there, and runs ``chip_smoke.py``'s checks and timings of
``row_quantize`` and ``block_quantize`` from this checkout, so that two
commits are read by the same code on the same card:

* phase 19's edges (``compare_fp8_quantizer_edges``): both quantizers
  bit-equal to their plain versions at every fp8 path shape and the
  warp-a-row path's K edges, both formats, bf16 and f32, aligned and at
  an odd offset, and bit-identical over two launches; ``encode_check``
  where the checkout has it;
* ``time_fp8_quantizers``: one vision layer's 12 calls (4,128 rows), one
  text layer's 12 (2,464) and the patch embedding's one (8,192 x 588), by
  graph replay, beside the bound; ``time_tensor_quantize``: the fp8 modes'
  ``tensor_quantize`` (E4M3) of each of those layers' weights (6, 6, 1);
  the fp8 forward's K-major W at the same weights by the checkout's route
  (``fp8_k_major_w``: the fold ``tensor_quantize_kt`` where the checkout
  has it, else ``tensor_quantize`` then ``transpose_bytes``) beside that
  pair (``fp8_pair``), both against the fold's bound (4 bytes a bf16
  value);
* phase 19's tensor-quantizer edges (``compare_tensor_quantizer_edges``,
  both formats; ``compare_kt_edges``) where the checkout has the entry
  points they need;
* the SASS of the built library (``cuobjdump -sass``): for each quantizer
  kernel its instructions, and per value the instructions of its main
  loops (a loop's body over the values one pass of it handles: the loads
  of a max loop, the stores of a cast loop) or, in a kernel without such
  loops, of one path through its body (the division's out-of-line slow
  path left out; at each branch whose two sides both convert, the side
  of E4M3 and of the division without the slow-path check) over the most
  values a thread holds (8 chunks of 8); ``sass_tensor``: the tensor
  quantizer's bf16 16-byte path a value (``tensor_sass``).

With ``--train-steps N``: also N CLIP train steps at 2 + 2 layers and full
width in ``fp8`` and ``fp8_mixed`` (batch 32, parameters, batches and kept
patches from ``--seed``), their losses and a SHA-256 of the final
parameters' bytes, so that two checkouts' steps can be held bit for bit.

Run it for two checkouts in turns (A, B, B, A) within one call to compare
them. Prints one JSON line and appends it to ``--out``. Needs one card;
exits 1 without one, and on any failed check.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
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

QUANTIZERS = ("row_quantize", "block_quantize")
VALUES_A_THREAD = 64          # the tile kernel's kMaxChunks x kChunk

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_HEX = re.compile(r"0x[0-9a-f]+")


def sass_functions(text: str) -> dict:
    """{mangled name: [(address, instruction) ...]} from ``cuobjdump
    -sass`` output."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line) if cur is not None else None
        if m:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def target(ins: str):
    """The address a branch or call goes to, else None."""
    op = opcode(ins)
    if not op.startswith(("BRA", "CALL")):
        return None
    found = _HEX.findall(ins.split(op, 1)[1])
    return int(found[-1], 16) if found else None


def tensor_sass(funcs: dict) -> dict:
    """Per value of x, the SASS of a library's tensor quantizer on bf16
    input and its 16-byte path, for each family the library holds: the
    one-launch kernel (granule 8, MODE 0: ``Li8E`` then ``Li0E`` last; fp8
    E4M3) walked as ``count_kernel`` walks a straight-line body (the
    barrier's and the partials' loops once) over the 128 values a thread
    holds; or an older commit's two kernels, the max loop's body over the
    values it loads plus the cast loop's over the values it stores."""
    out = {}
    for name, fn in funcs.items():
        if "__nv_bfloat16" not in name:
            continue
        m = re.search(r"(fp8_)?tensor_quantize_kernelI13__nv_bfloat16Li8E(Li0E)?Li0EEE", name)
        if m:
            body = main_body(fn)
            at = {a: k for k, (a, _) in enumerate(body)}
            out["fp8" if m.group(1) else "int8"] = dict(
                instructions=len(body), per_value=walk(body, 0, len(body), at) / 128,
                how="one path through the one-launch kernel over 128 values")
    old = {k: loop_counts(main_body(fn)) for k, fn in funcs.items() if "__nv_bfloat16" in k
           and ("absmax_partial" in k or "cast_tensorwise" in k)}
    if old and not out:
        per = sum(min((lp["instructions"] / lp[kind] for lp in loops if lp[kind]
                       and (kind == "stg" or not lp["stg"])), default=0.0)
                  for k, loops in old.items() for kind in (("ldg",) if "absmax" in k else ("stg",)))
        out["two passes"] = dict(per_value=per, how="max loop / loads + cast loop / stores")
    return out


def main_body(fn: list) -> list:
    """A kernel's instructions before its first out-of-line call target
    (the division's slow path), NOPs left out."""
    calls = [target(i) for _, i in fn if opcode(i).startswith("CALL")]
    end = min(c for c in calls if c is not None) if calls else fn[-1][0] + 1
    return [(a, i) for a, i in fn if a < end and opcode(i) != "NOP"]


def loop_counts(body: list) -> list:
    """The backward branches' loops of a body: instructions, loads, stores."""
    ops = [opcode(i) for _, i in body]
    at = {a: k for k, (a, _) in enumerate(body)}
    loops = []
    for k, (a, i) in enumerate(body):
        t = target(i)
        if t is not None and t <= a and t in at and opcode(i) == "BRA":
            seg = ops[at[t]:k + 1]
            loops.append(dict(instructions=len(seg), ldg=sum(o.startswith("LDG") for o in seg),
                              stg=sum(o.startswith("STG") for o in seg)))
    return loops


def f2fp_format(ins: str):
    m = re.search(r"F2FP\.\S*?(E4M3|E5M2)", ins)
    return m.group(1) if m else None


def count_kernel(fn: list) -> dict:
    """Instructions of one kernel and per value (see the module's note)."""
    body = main_body(fn)
    at = {a: k for k, (a, _) in enumerate(body)}
    res = dict(instructions=len(body))
    loops = loop_counts(body)
    cast = [lp for lp in loops if lp["stg"]]
    if cast:
        # the smallest loop that loads only (the max pass) and that stores (the cast)
        maxl = [lp for lp in loops if lp["ldg"] and not lp["stg"]]
        per = sum(lp["instructions"] / lp[kind] for lp, kind in (
            (min(cast, key=lambda x: x["instructions"]), "stg"),
            *(((min(maxl, key=lambda x: x["instructions"]), "ldg"),) if maxl else ())))
        return res | dict(per_value=per, how="loops' bodies over the values a pass handles")
    # straight-line: the instructions one thread runs at 8 chunks, where each
    # two-sided branch (the format, the division's route) runs one side
    n = walk(body, 0, len(body), at)
    return res | dict(per_value=n / VALUES_A_THREAD,
                      how=f"one path through the body (E4M3, the quickest division) over "
                          f"{VALUES_A_THREAD} values")


def split_at(body, k, at, hi):
    """(start of the second side, its end) when instruction k is a
    conditional forward branch whose first side (the fall-through) jumps
    over the second one and both sides hold conversions (F2FP), else None;
    the second side ends where the first side's jump lands, or at hi."""
    a, i = body[k]
    t = target(i)
    if t is None or t <= a or not i.startswith("@") or t not in at or at[t] > hi:
        return None
    t = at[t]
    over = [target(x) for _, x in body[k + 1:t] if opcode(x) == "BRA"]
    over = [at[j] for j in over if j is not None and j in at and at[j] >= t]
    if not over:
        return None
    y = min(max(over), hi)
    if not all(any(opcode(x).startswith("F2FP") for _, x in body[lo:up])
               for lo, up in ((k + 1, t), (t, y))):
        return None
    return t, y


def walk(body, lo, hi, at) -> int:
    """Instructions run from lo to hi taking, at each split, the side with
    fewer FCHK (the division without its slow-path check), then the E4M3
    side."""
    n, k = 0, lo
    while k < hi:
        sp = split_at(body, k, at, hi)
        if sp is None:
            n, k = n + 1, k + 1
            continue
        t, y = sp
        sides = ((k + 1, t), (t, y))
        key = lambda s: (sum(opcode(x) == "FCHK" for _, x in body[s[0]:s[1]]),
                         not any(f2fp_format(x) == "E4M3" for _, x in body[s[0]:s[1]]))
        n += 1 + walk(body, *min(sides, key=key), at)
        k = y
    return n


def ptxas_quantizers(log: str) -> dict:
    """{quantizer kernel: its registers and spills} from ``-Xptxas -v``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if any(q in m.group(1) for q in QUANTIZERS) else None
        elif name and ("Used" in line or "spill" in line):
            out[name] = (out.get(name, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return out


def sass_counts(lib_path: str) -> dict:
    """Per quantizer kernel of the library (mangled names holding
    ``row_quantize`` or ``block_quantize``), its counts."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    funcs = sass_functions(text)
    return ({name: count_kernel(fn) for name, fn in funcs.items()
             if any(q in name for q in QUANTIZERS)}, tensor_sass(funcs))


def named_leaves(tree, prefix=""):
    """(path, tensor) of a parameter tree's leaves, in name order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def clip_steps(torch, C, cfg, dev, seed, steps):
    """``steps`` CLIP train steps at 2 + 2 layers, full width, batch 32, in
    each fp8 kernel mode (chip_smoke's ``path_run``): per mode the losses and
    the SHA-256 of the final parameters' bytes, leaf by leaf in name order."""
    from repro_torch.models import params as PRM
    from repro_torch.models.clip import patch_keep_sampler
    small = dataclasses.replace(cfg, vision_layers=2, text_layers=2)
    draw = patch_keep_sampler(small)
    path = types.SimpleNamespace(small=small, opt=C.CLIP_OPT)
    p0 = PRM.init_params(C.param_specs_of(small), seed, device="cpu")
    batches = C.clip_batches(torch, small, steps, C.CLIP_BATCH, "cpu", seed)
    keeps = [draw(torch.Generator().manual_seed(seed + i)) for i in range(steps)]
    out = {}
    for mode in C.FP8_KERNEL_MODES:
        losses, params = C.path_run(torch, path, dev, mode, p0, batches, keeps)
        h = hashlib.sha256()
        for name, leaf in named_leaves(params):
            h.update(name.encode())
            h.update(leaf.detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
        out[mode] = dict(losses=losses, params_sha256=h.hexdigest())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-steps", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "ab_fp8_quantize.jsonl"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ab_fp8_quantize: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    sys.path.insert(0, os.path.abspath(args.src))       # before chip_smoke's own src
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.fp8_matmul import build as F8B
    from repro_torch.kernels.fp8_matmul import ops as F8
    from repro_torch.kernels.fp8_matmul import ref as F8REF
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    if src != os.path.abspath(args.src):
        print(f"ab_fp8_quantize: repro_torch came from {src}, not {args.src}", file=sys.stderr)
        return 1
    M = types.SimpleNamespace(F8=F8, F8REF=F8REF)
    smi = C.nvidia_smi_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib, log = F8B.build()
    F8B.load()
    sass, sass_tensor = sass_counts(str(lib))
    res = dict(tag=args.tag, src=os.path.relpath(src, ROOT), card=smi,
               build_s=time.perf_counter() - t0,
               ptxas=ptxas_quantizers(log), sass=sass, sass_tensor=sass_tensor)
    try:
        worst, n, caught = C.compare_fp8_quantizer_edges(torch, M, dev, args.seed + 43,
                                                         encode_check=hasattr(F8, "encode_check"))
        res["checks"] = dict(comparisons=n, worst=worst, faults_caught=caught)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 37)
        times = {}
        for tower, rows, _, _, _, lins in C.clip_shapes(get_config("clip-vit-huge")):
            got = C.time_fp8_quantizers(torch, M, gen, dev, rows, C.quantizer_calls(lins),
                                        f"one {tower} layer", plain=False)
            for kernel, r in got.items():
                times[f"{kernel} {tower}"] = {k: r[k] for k in ("ms", "eager_ms", "calls",
                                                                "work")} | {
                    "bound_ms": r["bound"][0], "bound_share": r["bound"][0] / r["ms"]}
            # the fp8 modes' tensor_quantize of the layer's weights (E4M3)
            r = C.time_tensor_quantize(torch, lambda w: F8.tensor_quantize(w, "e4m3"), None,
                                       gen, dev, C.tower_weights(lins), f"one {tower} layer")
            times[f"fp8_tensor_quantize {tower}"] = {k: r[k] for k in (
                "ms", "eager_ms", "calls", "work")} | {"bound_ms": r["bound"][0],
                                                      "bound_share": r["bound"][0] / r["ms"]}
            # the forward's K-major W: this checkout's route, and the pair
            kt = getattr(F8, "tensor_quantize_kt", None)
            pair = lambda w: F8.transpose_bytes(F8.tensor_quantize(w, "e4m3")[0])
            routes = {"fp8_k_major_w": (lambda w: kt(w, "e4m3")) if kt else pair,
                      "fp8_pair": pair}
            for key, fn in routes.items():
                r = C.time_tensor_quantize(torch, fn, None, gen, dev, C.tower_weights(lins),
                                           f"one {tower} layer ({key})", k_major=True)
                times[f"{key} {tower}"] = {k: r[k] for k in (
                    "ms", "eager_ms", "calls", "work")} | {
                    "bound_ms": r["bound"][0], "bound_share": r["bound"][0] / r["ms"],
                    "route": "tensor_quantize_kt" if kt and key == "fp8_k_major_w"
                             else "tensor_quantize + transpose_bytes"}
        res["times"] = times
        if args.train_steps:
            res["clip_steps"] = clip_steps(torch, C, get_config("clip-vit-huge"), dev, args.seed,
                                           args.train_steps)
    except C.Failure as e:
        print(f"ab_fp8_quantize ({args.tag}): FAILED: {e}", file=sys.stderr)
        return 1
    res["seconds"] = time.perf_counter() - t0
    print(f"[ab] {args.tag}: " + json.dumps(dict(
        card=smi, us={k: r["ms"] * 1e3 for k, r in times.items()},
        sass_per_value={k: round(v["per_value"], 2) for k, v in
                        {**res["sass"], **res["sass_tensor"]}.items()},
        comparisons=n, seconds=res["seconds"], clip_steps=res.get("clip_steps"))))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as fh:
        fh.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
