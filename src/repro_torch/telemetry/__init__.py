"""Flight recorder: unified telemetry for train + serve, the port of
``repro/telemetry/__init__.py``.

One ``Telemetry`` object bundles the three observability primitives:

  * a :class:`~repro_torch.telemetry.sink.JsonlSink` writing
    schema-versioned event records (``--telemetry PATH``),
  * host-side :meth:`Telemetry.span` phase timing (records with
    ``kind="span"`` — exported to Chrome traces by ``telemetry/report``),
  * a ``torch.profiler`` window (``--profile-steps A:B``) started/stopped
    by :meth:`Telemetry.maybe_profile` at step granularity, host and CUDA
    activity, written as a Chrome trace into ``profile_dir`` when the
    window closes (the ``profile`` stop event names the file).

Everything degrades to a no-op when built without a path: the disabled
object is safe to thread through Trainer/ServeEngine unconditionally,
and the hot loops never branch on more than one attribute check. The
no-extra-sync contract: telemetry never fetches a tensor or synchronizes
the device; it only records what the host already knows (pinned by
``tests/test_torch_telemetry.py``). The profiler window is opt-in and
waits for the card when it stops.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Optional, Tuple

from repro_torch.telemetry.registry import (Counter, Gauge, Histogram,  # noqa: F401
                                            MetricsRegistry)
from repro_torch.telemetry.sink import (SCHEMA_VERSION, JsonlSink,  # noqa: F401
                                        to_chrome_trace, validate_file,
                                        validate_record)


def parse_profile_steps(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """Parse an ``A:B`` CLI window into an inclusive (start, stop) pair.

    >>> parse_profile_steps("3:7")
    (3, 7)
    >>> parse_profile_steps(None) is None
    True
    """
    if not spec:
        return None
    try:
        a, b = spec.split(":")
        a, b = int(a), int(b)
    except ValueError:
        raise ValueError(f"--profile-steps wants 'A:B', got {spec!r}")
    if a > b or a < 0:
        raise ValueError(f"--profile-steps window {a}:{b} is empty")
    return a, b


class Telemetry:
    """Sink + spans + profiler window behind one object.

    ``Telemetry()`` (no path, no profile window) is fully disabled:
    ``emit``/``span`` are no-ops and ``enabled`` is False, so callers
    thread it unconditionally and skip building event payloads with one
    ``if tele.enabled`` check.
    """

    def __init__(self, path: Optional[str] = None, *,
                 profile_steps: Optional[Tuple[int, int]] = None,
                 profile_dir: str = "/tmp/repro-profile",
                 program: str = "", meta: Optional[Dict[str, Any]] = None):
        self.sink = (JsonlSink(path, program=program, meta=meta)
                     if path else None)
        self.profile_steps = profile_steps
        self.profile_dir = profile_dir
        self._profiling = False
        self._profiler = None
        self._closed = False

    @classmethod
    def from_config(cls, cfg, *, program: str = "",
                    meta: Optional[Dict[str, Any]] = None) -> "Telemetry":
        """Build from a :class:`repro_torch.configs.base.TelemetryConfig`
        (or None → disabled)."""
        if cfg is None:
            return cls()
        return cls(cfg.path, profile_steps=cfg.profile_steps,
                   profile_dir=cfg.profile_dir, program=program, meta=meta)

    @property
    def enabled(self) -> bool:
        return self.sink is not None

    # -- events ------------------------------------------------------------
    def emit(self, kind: str, **fields) -> None:
        if self.sink is not None:
            self.sink.emit(kind, **fields)

    def emit_span(self, name: str, t_start: float, dur_s: float,
                  **fields) -> None:
        """Record an already-timed phase. ``t_start`` is ``time.time()``
        epoch seconds of the span start (so the Chrome export places it
        correctly); ``ts`` of the record is the span *end*."""
        if self.sink is not None:
            self.sink.emit("span", ts=t_start + dur_s, name=name,
                           dur_s=dur_s, **fields)

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        """Time a host-side phase; no-op (no clock reads) when disabled."""
        if self.sink is None:
            yield
            return
        t0 = time.time()
        try:
            yield
        finally:
            self.emit_span(name, t0, time.time() - t0, **fields)

    # -- profiler window ----------------------------------------------------
    def maybe_profile(self, step: int) -> None:
        """Start/stop a ``torch.profiler`` trace around the configured
        inclusive step window. Call once per step/wave; idempotent."""
        if self.profile_steps is None:
            return
        a, b = self.profile_steps
        if not self._profiling and a <= step <= b:
            try:
                import torch
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                os.makedirs(self.profile_dir, exist_ok=True)
                self._profiler = torch.profiler.profile(activities=acts)
                self._profiler.start()
                self._profiling = True
                self.emit("profile", event="start", step=step,
                          dir=self.profile_dir)
            except Exception as e:          # profiling must never kill a run
                self._profiler = None
                self.emit("profile", event="error", step=step, error=str(e))
                self.profile_steps = None
        elif self._profiling and step > b:
            self._stop_profile(step)

    def _stop_profile(self, step: int) -> None:
        a, b = self.profile_steps or (step, step)
        path = os.path.join(self.profile_dir, f"trace_steps_{a}-{b}.json")
        try:
            self._profiler.stop()
            self._profiler.export_chrome_trace(path)
            self.emit("profile", event="stop", step=step,
                      dir=self.profile_dir, file=path)
        except Exception as e:
            self.emit("profile", event="error", step=step, error=str(e))
        self._profiler = None
        self._profiling = False
        self.profile_steps = None

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._profiling:
            self._stop_profile(-1)
        if self.sink is not None:
            self.sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


#: module-level disabled instance — the default for every instrumented
#: consumer (a shared no-op is fine: it holds no state when disabled)
NULL = Telemetry()


def as_telemetry(t: Optional[Telemetry]) -> Telemetry:
    """Normalize an optional telemetry argument to a usable object."""
    return NULL if t is None else t
