"""Telemetry reader: validate, summarize, export Chrome traces.

    python -m repro_torch.telemetry.report run.jsonl            # summary
    python -m repro_torch.telemetry.report --validate run.jsonl # exit 1 if bad
    python -m repro_torch.telemetry.report --chrome out.json run.jsonl

A copy of the JAX package's ``repro/telemetry/report.py`` (pure Python;
the port imports nothing of ``repro``): the same summary, validation and
Chrome export of the same files.

The summary prints, per file: the meta header, step-time / ITL
percentiles (recomputed through the shared registry histograms),
the quant-health (fp8 fallback-rate) timeline, the anomaly/rewind
timeline, and a per-request lifecycle table for serve runs.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from repro_torch.telemetry.registry import Histogram
from repro_torch.telemetry.sink import read_jsonl, to_chrome_trace, validate_file


def load(path: str) -> List[Dict]:
    """Decode a telemetry file (raises on undecodable lines)."""
    out = []
    for i, rec, err in read_jsonl(path):
        if err:
            raise ValueError(err)
        out.append(rec)
    return out


def _pcts(name: str, vals: List[float], unit: float = 1e3,
          suffix: str = "ms") -> str:
    h = Histogram(name)
    h.observe_many(vals)
    return (f"{name}: n={h.n} p50={h.percentile(50) * unit:.2f}{suffix} "
            f"p95={h.percentile(95) * unit:.2f}{suffix}")


def summarize(records: List[Dict], out=None) -> None:
    # resolve sys.stdout at call time, not def time (test capture swaps it)
    w = (out or sys.stdout).write
    meta = records[0] if records and records[0].get("kind") == "meta" else {}
    kinds: Dict[str, int] = {}
    for r in records:
        kinds[r.get("kind", "?")] = kinds.get(r.get("kind", "?"), 0) + 1
    w(f"program={meta.get('program', '?')} schema={meta.get('schema')} "
      f"records={len(records)}\n")
    w("kinds: " + " ".join(f"{k}={n}" for k, n in sorted(kinds.items()))
      + "\n")

    # train: step timeline + quant-health + anomalies/rewinds
    steps = [r for r in records if r.get("kind") == "train_step"]
    if steps:
        w(_pcts("step_dt", [r.get("dt", 0.0) for r in steps]) + "\n")
        losses = [r.get("loss") for r in steps]
        w(f"steps {steps[0].get('step')}..{steps[-1].get('step')} "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}\n")
        qh_keys = sorted({k for r in steps for k in r if k.startswith("qh/")})
        for k in qh_keys:
            vals = [(r["step"], r[k]) for r in steps if k in r]
            if vals:
                first, last = vals[0], vals[-1]
                peak = max(vals, key=lambda sv: sv[1])
                w(f"{k}: first={first[1]:.3g} last={last[1]:.3g} "
                  f"peak={peak[1]:.3g}@step{peak[0]}\n")
    for r in records:
        if r.get("kind") == "anomaly":
            w(f"ANOMALY step {r.get('step')}: {r.get('anomaly')} "
              f"({r.get('detail', '')})\n")
        elif r.get("kind") == "rewind":
            w(f"REWIND step {r.get('step')} -> {r.get('restored_step')} "
              f"(attempt {r.get('attempt')}, skipped {r.get('skipped')})\n")

    # serve: wave ITL + request lifecycle table
    waves = [r for r in records if r.get("kind") == "wave"]
    if waves:
        w(_pcts("wave_dur", [r.get("dur_s", 0.0) for r in waves]) + "\n")
        modes: Dict[str, int] = {}
        for r in waves:
            modes[r.get("mode", "?")] = modes.get(r.get("mode", "?"), 0) + 1
        w("waves: " + " ".join(f"{k}={n}" for k, n in sorted(modes.items()))
          + "\n")
    reqs = [r for r in records if r.get("kind") == "request"]
    if reqs:
        by_uid: Dict[int, List[Dict]] = {}
        for r in reqs:
            by_uid.setdefault(int(r["uid"]), []).append(r)
        w(f"requests: {len(by_uid)}\n")
        w(f"{'uid':>5} {'events':>7} {'chunks':>7} {'ttft_ms':>8} "
          f"{'preempt':>8}  lifecycle\n")
        for uid in sorted(by_uid):
            evs = by_uid[uid]
            names = [e.get("event", "?") for e in evs]
            ttft = next((e.get("ttft_s") for e in evs
                         if e.get("event") == "first_token"), None)
            chunks = sum(1 for n in names if n == "prefill_chunk")
            pre = sum(1 for n in names if n == "preempted")
            # compress prefill_chunk runs for readability
            path, i = [], 0
            while i < len(names):
                j = i
                while j < len(names) and names[j] == names[i]:
                    j += 1
                path.append(names[i] if j - i == 1
                            else f"{names[i]}x{j - i}")
                i = j
            w(f"{uid:>5} {len(evs):>7} {chunks:>7} "
              f"{'-' if ttft is None else f'{ttft * 1e3:8.2f}'} "
              f"{pre:>8}  {' > '.join(path)}\n")
    stats = [r for r in records if r.get("kind") == "serve_stats"]
    for r in stats:
        keep = ("new_tokens", "tokens_per_s", "itl_p95_s", "ttft_p95_s",
                "spec_acceptance_rate", "supervisor_rewinds")
        row = {k: r[k] for k in keep if k in r}
        w(f"serve_stats: {row}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report",
        description="validate / summarize / export telemetry JSONL files")
    ap.add_argument("paths", nargs="+", help="telemetry .jsonl files")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check only; exit nonzero on any "
                         "malformed record")
    ap.add_argument("--chrome", default=None, metavar="OUT",
                    help="write a chrome://tracing / Perfetto trace JSON")
    args = ap.parse_args(argv)

    rc = 0
    for path in args.paths:
        errs = validate_file(path)
        if errs:
            rc = 1
            print(f"{path}: INVALID ({len(errs)} errors)")
            for e in errs[:20]:
                print(f"  {e}")
            if len(errs) > 20:
                print(f"  ... {len(errs) - 20} more")
            continue
        records = load(path)
        print(f"{path}: OK ({len(records)} records)")
        if args.chrome:
            trace = to_chrome_trace(records)
            out = (args.chrome if len(args.paths) == 1
                   else f"{args.chrome}.{path.replace('/', '_')}.json")
            with open(out, "w") as f:
                json.dump(trace, f)
            print(f"  chrome trace -> {out} "
                  f"({len(trace['traceEvents'])} events)")
        if not args.validate:
            summarize(records)
    return rc


if __name__ == "__main__":
    sys.exit(main())
