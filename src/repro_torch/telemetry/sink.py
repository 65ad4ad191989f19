"""JSONL event sink + span tracer + Chrome-trace exporter.

A copy of the JAX package's ``repro/telemetry/sink.py`` (pure Python; the
port imports nothing of ``repro``), so both packages write and read the
same files.

Every record is one JSON object per line with at least ``{"ts", "kind"}``
(``ts`` = seconds, ``time.time()`` epoch); step-scoped records carry
``"step"``, request-scoped records carry ``"uid"``. The first record of
a file is ``kind="meta"`` with the schema version, so a reader can
reject files written by an incompatible writer before parsing anything
else. Spans (host-side phases: prefill wave, decode wave, checkpoint
save, supervisor rewind, ...) are ordinary records with ``kind="span"``,
``name`` and ``dur_s`` — ``to_chrome_trace`` turns them into Perfetto /
``chrome://tracing`` duration events and everything else into instant
events, so any run file loads directly in a trace viewer.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1

# per-kind required fields (beyond ts/kind). Unknown kinds are allowed —
# forward compatibility — but these core kinds are pinned so the train
# and serve instrumentation can't silently emit malformed records.
KIND_REQUIRED: Dict[str, tuple] = {
    "meta": ("schema", "program"),
    "span": ("name", "dur_s"),
    "train_step": ("step", "loss"),
    "flush": ("step", "n_steps"),
    "checkpoint": ("step",),
    "spike": ("step",),
    "anomaly": ("step", "anomaly"),
    "rewind": ("step", "restored_step", "skipped"),
    "save_failure": ("step",),
    "request": ("uid", "event"),
    "wave": ("wave", "mode"),
    "serve_stats": (),
    "profile": ("event",),
}


class JsonlSink:
    """Append-only schema-versioned JSONL writer.

    Flushes per record: telemetry must survive the process dying right
    after an anomaly — that crash is exactly the record you want.
    """

    def __init__(self, path: str, *, program: str = "",
                 meta: Optional[Dict[str, Any]] = None):
        self.path = path
        self._f = open(path, "w")
        self.n_records = 0
        self.emit("meta", schema=SCHEMA_VERSION, program=program,
                  **(meta or {}))

    def emit(self, kind: str, *, ts: Optional[float] = None,
             **fields) -> None:
        if self._f is None:
            return
        rec = {"ts": time.time() if ts is None else ts, "kind": kind}
        rec.update(fields)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        self.n_records += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- validation -------------------------------------------------------------

def validate_record(rec: Any, *, first: bool = False) -> List[str]:
    """Schema errors for one decoded record ([] = valid)."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    ts = rec.get("ts")
    if not isinstance(ts, (int, float)) or isinstance(ts, bool):
        errs.append("missing/non-numeric 'ts'")
    kind = rec.get("kind")
    if not isinstance(kind, str) or not kind:
        errs.append("missing/non-string 'kind'")
        return errs
    if first and kind != "meta":
        errs.append(f"first record kind {kind!r}, expected 'meta'")
    if kind == "meta" and rec.get("schema") != SCHEMA_VERSION:
        errs.append(f"schema {rec.get('schema')!r} != {SCHEMA_VERSION}")
    for f in KIND_REQUIRED.get(kind, ()):
        if f not in rec:
            errs.append(f"kind {kind!r} missing field {f!r}")
    if kind == "span":
        d = rec.get("dur_s")
        if d is not None and (not isinstance(d, (int, float))
                              or isinstance(d, bool) or d < 0):
            errs.append(f"span dur_s {d!r} not a non-negative number")
    return errs


def read_jsonl(path: str):
    """Yield (line_number, record_or_None, error_or_None) per line."""
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                yield i, json.loads(line), None
            except json.JSONDecodeError as e:
                yield i, None, f"line {i}: invalid JSON ({e.msg})"


def validate_file(path: str) -> List[str]:
    """All schema errors in a telemetry file ([] = valid)."""
    errs: List[str] = []
    seen = 0
    for i, rec, err in read_jsonl(path):
        if err:
            errs.append(err)
            continue
        for e in validate_record(rec, first=(seen == 0)):
            errs.append(f"line {i}: {e}")
        seen += 1
    if seen == 0:
        errs.append("empty file (no meta record)")
    return errs


# -- Chrome trace export ----------------------------------------------------

def to_chrome_trace(records: List[Dict]) -> Dict:
    """Convert telemetry records to the Chrome trace-event JSON format.

    Spans become "X" (complete duration) events; everything else becomes
    an "i" (instant) event carrying its fields as args. Request-scoped
    records get their ``uid`` as the tid so each request renders as its
    own track; step-scoped records share track 0. Timestamps are µs
    relative to the first record.
    """
    if not records:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(r["ts"] for r in records if isinstance(r.get("ts"), (int, float)))
    events = []
    for r in records:
        ts_us = (r.get("ts", t0) - t0) * 1e6
        kind = r.get("kind", "?")
        tid = int(r["uid"]) + 1 if "uid" in r else 0
        args = {k: v for k, v in r.items() if k not in ("ts", "kind")}
        if kind == "span":
            dur_us = float(r.get("dur_s", 0.0)) * 1e6
            events.append({"ph": "X", "name": r.get("name", "span"),
                           "cat": kind, "pid": 0, "tid": tid,
                           "ts": ts_us - dur_us, "dur": dur_us,
                           "args": args})
        else:
            name = kind if "event" not in r else f"{kind}:{r['event']}"
            events.append({"ph": "i", "s": "t", "name": name, "cat": kind,
                           "pid": 0, "tid": tid, "ts": ts_us,
                           "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
