"""RMS_t monitoring (paper §3.4 + Figure 9).

A copy of ``repro/stability/rms_monitor.py`` (pure Python and numpy; the
port imports nothing of ``repro``).

The StableAdamW update already computes per-tensor
RMS_t = sqrt(mean(g²/max(u,ε²))); this module keeps host-side history and
implements the paper's detection threshold (App. D: an *RMS spike* is any
step with RMS_t ≥ 2.3 in a watched layer — canonically the patch embedding,
``visual.conv1.weight`` in OpenCLIP, the patch-embed kernel here).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

RMS_SPIKE_THRESHOLD = 2.3     # paper App. D
PREDICT_WINDOW = (1, 8)       # loss spike follows RMS spike by 1-8 iters


@dataclass
class RMSMonitor:
    """Accumulates per-layer RMS_t series; flags spikes; matches them
    against loss spikes with the paper's 1-8-iteration window."""
    watch_layers: Sequence[str] = ()
    threshold: float = RMS_SPIKE_THRESHOLD
    history: Dict[str, List[float]] = field(default_factory=dict)
    steps: List[int] = field(default_factory=list)

    def record(self, step: int, rms_tree: dict):
        flat = _flatten(rms_tree)
        self.steps.append(int(step))
        for name, val in flat.items():
            if self.watch_layers and not any(w in name for w in self.watch_layers):
                continue
            self.history.setdefault(name, []).append(float(val))

    def spike_steps(self, layer: str) -> List[int]:
        series = self.history.get(layer, [])
        raw = [self.steps[i] for i, v in enumerate(series)
               if v >= self.threshold]
        return _dedup_events(raw, window=10)

    def layers(self) -> List[str]:
        return sorted(self.history)

    def rollback(self, step: int):
        """Drop records at steps >= ``step`` (checkpoint rewind): the
        re-executed steps will be recorded again."""
        keep = [i for i, s in enumerate(self.steps) if s < step]
        self.steps = [self.steps[i] for i in keep]
        self.history = {name: [series[i] for i in keep if i < len(series)]
                        for name, series in self.history.items()}

    def predicts_loss_spike(self, layer: str, loss_spike_steps: Sequence[int]
                            ) -> Dict[str, float]:
        """App. D analysis: fraction of loss spikes that follow an RMS spike
        by 1-8 iterations, plus the chance-level probability."""
        rms_spikes = self.spike_steps(layer)
        if not loss_spike_steps:
            return {"n_loss_spikes": 0, "n_predicted": 0, "n_rms_spikes":
                    len(rms_spikes), "chance_prob": 0.0}
        lo, hi = PREDICT_WINDOW
        predicted = 0
        for ls in loss_spike_steps:
            if any(lo <= ls - rs <= hi for rs in rms_spikes):
                predicted += 1
        total_steps = max(self.steps) - min(self.steps) + 1 if self.steps else 1
        # probability a random step lands 1-8 after any RMS spike
        covered = set()
        for rs in rms_spikes:
            covered.update(range(rs + lo, rs + hi + 1))
        chance = len(covered) / max(total_steps, 1)
        return {"n_loss_spikes": len(loss_spike_steps),
                "n_predicted": predicted,
                "n_rms_spikes": len(rms_spikes),
                "chance_prob": chance}


def _flatten(tree, prefix="") -> Dict[str, float]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}." if prefix or True else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix.rstrip(".")] = np.asarray(tree).item() \
            if np.ndim(tree) == 0 else float(np.mean(tree))
    return out


def _dedup_events(steps: List[int], window: int = 10) -> List[int]:
    """Paper App. D: multiple spikes within 10 iterations count once,
    keeping the earliest."""
    out: List[int] = []
    for s in sorted(steps):
        if not out or s - out[-1] > window:
            out.append(s)
    return out
