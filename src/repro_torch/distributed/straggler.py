"""Straggler/step-time watchdog (host-side fault tolerance).

A copy of ``repro/distributed/straggler.py`` (pure Python; the port
imports nothing of ``repro``).

Tracks an EMA of step wall-time; flags steps slower than `threshold`× the
EMA as straggler events, keeps a log, and exposes an `on_slow` callback the
trainer uses to (a) record the event, (b) optionally trigger an early
checkpoint so a failing host loses minimal work. On a real cluster this is
where you would also ping the coordinator / trigger task preemption.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class StragglerWatchdog:
    threshold: float = 2.0
    ema_alpha: float = 0.1
    warmup_steps: int = 5
    ema: Optional[float] = None
    events: List[dict] = field(default_factory=list)
    on_slow: Optional[Callable[[dict], None]] = None
    _n: int = 0
    _t0: Optional[float] = None

    def step_start(self):
        self._t0 = time.monotonic()

    def step_end(self, step: int) -> dict:
        return self.record(step, time.monotonic() - self._t0)

    def record(self, step: int, dt: float) -> dict:
        """Feed an externally measured step time (e.g. the trainer's
        amortized per-step wall time over an async-dispatch window —
        individual step_end timings only see dispatch time there)."""
        self._n += 1
        slow = False
        if self.ema is not None and self._n > self.warmup_steps \
                and dt > self.threshold * self.ema:
            slow = True
            ev = {"step": step, "dt": dt, "ema": self.ema,
                  "ratio": dt / self.ema}
            self.events.append(ev)
            if self.on_slow:
                self.on_slow(ev)
        # slow steps don't poison the EMA
        if not slow:
            self.ema = dt if self.ema is None else \
                (1 - self.ema_alpha) * self.ema + self.ema_alpha * dt
        return {"dt": dt, "ema": self.ema, "slow": slow}
