"""Loss-spike detection heuristic (paper Appendix D).

A copy of ``repro/stability/spike_detector.py`` (pure Python and numpy;
the port imports nothing of ``repro``).

A loss spike event is a step where the loss exceeds the running mean by
3.2 running standard deviations, with: (i) the first 1000 iterations
ignored (low lr), (ii) events deduplicated within 10 iterations (earliest
kept), and (iii) an event only counts if multiple deviations occur within
an interval of 10 ("indicates that loss has meaningfully spiked").

Two consumption modes over the same statistics:

  * ``spike_steps()`` — O(n) full-history recompute, the post-mortem
    oracle (and the reference the incremental path is pinned against).
  * ``observe(step, loss)`` — O(deviations) incremental update returning
    the events *newly confirmed* by this observation, so an online
    supervisor can react at flush granularity.  ``record`` routes through
    the same state, so mixing the two stays consistent.

``rollback(step)`` truncates history to steps < ``step`` and replays the
running statistics — the supervisor calls it after a checkpoint rewind so
re-executed steps are observed exactly once.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from repro_torch.stability.rms_monitor import _dedup_events


@dataclass
class LossSpikeDetector:
    z_threshold: float = 3.2
    ignore_first: int = 1000
    dedup_window: int = 10
    min_deviations_in_window: int = 2
    ema_alpha: float = 0.02       # running-mean horizon ≈ 50 steps
    min_history: int = 20         # steps of stats before detection starts

    steps: List[int] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)

    # incremental mirror of spike_steps()'s loop state (same float64 ops in
    # the same order, so observe()-accumulated events match the recompute
    # bit-for-bit)
    _mean: float = 0.0
    _var: float = 0.0
    _deviations: List[int] = field(default_factory=list)
    _emitted: List[int] = field(default_factory=list)

    def record(self, step: int, loss: float):
        self.observe(step, loss)

    def observe(self, step: int, loss: float) -> List[int]:
        """Incremental update; returns spike events newly *confirmed* by
        this observation (an event's step can precede ``step`` by up to
        ``dedup_window``: confirmation needs a second deviation)."""
        self.steps.append(int(step))
        self.losses.append(float(loss))
        self._advance(len(self.losses) - 1)
        return self._newly_confirmed()

    def _advance(self, i: int):
        """Replay spike_steps()'s loop body for element i (same arithmetic)."""
        l = np.float64(self.losses[i])
        if i == 0:
            self._mean, self._var = l, np.float64(0.0)
        a = self.ema_alpha
        std = np.sqrt(max(self._var, 1e-12))
        if (self.steps[i] >= self.ignore_first and i >= self.min_history
                and l > self._mean + self.z_threshold * std and std > 0):
            self._deviations.append(int(self.steps[i]))
        self._mean = (1 - a) * self._mean + a * l
        self._var = (1 - a) * self._var + a * (l - self._mean) ** 2

    def _confirmed(self) -> List[int]:
        if len(self.losses) < 10:
            return []
        confirmed = [s for s in self._deviations
                     if sum(1 for d in self._deviations
                            if abs(d - s) <= self.dedup_window)
                     >= self.min_deviations_in_window]
        return _dedup_events(confirmed, window=self.dedup_window)

    def _newly_confirmed(self) -> List[int]:
        events = self._confirmed()
        known = set(self._emitted)
        new = [e for e in events if e not in known]
        self._emitted.extend(new)
        return new

    def events(self) -> List[int]:
        """All events confirmed so far via the incremental path."""
        return list(self._emitted)

    def rollback(self, step: int):
        """Drop observations at steps >= ``step`` (checkpoint rewind) and
        rebuild the incremental state from the surviving history."""
        keep = [(s, l) for s, l in zip(self.steps, self.losses) if s < step]
        self.steps = [s for s, _ in keep]
        self.losses = [l for _, l in keep]
        self._deviations, self._emitted = [], []
        self._mean, self._var = 0.0, 0.0
        for i in range(len(self.losses)):
            self._advance(i)
        self._emitted = self._confirmed()

    def spike_steps(self) -> List[int]:
        if len(self.losses) < 10:
            return []
        losses = np.asarray(self.losses)
        steps = np.asarray(self.steps)
        mean = losses[0]
        var = 0.0
        deviations = []
        a = self.ema_alpha
        for i, l in enumerate(losses):
            std = np.sqrt(max(var, 1e-12))
            if (steps[i] >= self.ignore_first and i >= self.min_history
                    and l > mean + self.z_threshold * std and std > 0):
                deviations.append(int(steps[i]))
            else:
                # only update the running stats on non-deviant steps so a
                # spike does not inflate its own baseline
                mean = (1 - a) * mean + a * l
                var = (1 - a) * var + a * (l - mean) ** 2
                continue
            mean = (1 - a) * mean + a * l
            var = (1 - a) * var + a * (l - mean) ** 2
        # require >= min_deviations within dedup_window (App. D)
        confirmed = [s for s in deviations
                     if sum(1 for d in deviations
                            if abs(d - s) <= self.dedup_window)
                     >= self.min_deviations_in_window]
        return _dedup_events(confirmed, window=self.dedup_window)
