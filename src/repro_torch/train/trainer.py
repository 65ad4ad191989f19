"""Host training loop: the port of ``repro/train/trainer.py``.

``Trainer.run`` steps the train step over a batch source, keeps the
metrics on the device between flush points and fetches a window of them
in one transfer; at each flush the host bookkeeping runs: the straggler
watchdog on the amortized step time, the loss-spike detector and the
per-tensor RMS_t monitor (paper §3.4 / App. D), the history and the
hooks. ``stability_report`` gives the App.-D RMS-spike -> loss-spike
analysis.

Not ported yet, and raising ``NotImplementedError`` when asked for:
checkpoints (``checkpoint_dir``; ``checkpoint/manager.py``, ROADMAP.md
Queue 1 #3), fault injection (``fault_plan``; self-healing training,
Queue 1 #7) and the flight recorder (``telemetry``; Queue 1 #7).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.distributed.straggler import StragglerWatchdog
from repro_torch.stability import LossSpikeDetector, RMSMonitor
from repro_torch.train.train_step import TrainState


@dataclasses.dataclass
class TrainerHooks:
    on_step: Optional[Callable[[int, Dict], None]] = None
    on_spike: Optional[Callable[[int], None]] = None
    on_slow: Optional[Callable[[Dict], None]] = None


def _unported(what: str, item: str):
    raise NotImplementedError(f"Trainer({what}=...) is not ported yet: it comes with "
                              f"{item} (ROADMAP.md Queue 1)")


def fetch_metrics(window: List[Dict]) -> List[Dict]:
    """Every tensor of a window of metrics dicts (including the RMS_t tree)
    on the host, in one device-to-host transfer: a 0-d tensor as a float,
    a vector (CLIP's per-layer ``feature_stats``) as a list of floats."""
    def flat(tree, keys=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, keys + (k,))
        else:
            yield keys, tree

    items = [(i, keys, t) for i, m in enumerate(window) for keys, t in flat(m)]
    out: List[Dict] = [{} for _ in window]
    if not items:
        return out
    values = torch.cat([t.detach().float().reshape(-1) for _, _, t in items]).tolist()
    at = 0
    for i, keys, t in items:
        n = t.numel()
        v = values[at] if t.dim() == 0 else values[at:at + n]
        at += n
        d = out[i]
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = v
    return out


class Trainer:
    def __init__(self, train_step_fn: Callable, state: TrainState, *,
                 checkpoint_dir: Optional[str] = None,
                 watch_layers=("patch_embed", "embed"),
                 hooks: Optional[TrainerHooks] = None,
                 log_every: int = 10,
                 fault_plan=None,
                 telemetry=None):
        if checkpoint_dir is not None:
            _unported("checkpoint_dir", "checkpoint/manager.py (Queue 1 #3)")
        if fault_plan is not None:
            _unported("fault_plan", "self-healing training (Queue 1 #7)")
        if telemetry is not None:
            _unported("telemetry", "the flight recorder (Queue 1 #7)")
        self.step_fn = train_step_fn
        self.state = state
        self.watchdog = StragglerWatchdog()
        self.watchdog.on_slow = self._on_slow
        self.rms_monitor = RMSMonitor(watch_layers=watch_layers)
        self.spike_detector = LossSpikeDetector(ignore_first=0)
        self.hooks = hooks or TrainerHooks()
        self.log_every = log_every
        self.history: List[Dict] = []
        self.counters: Dict[str, int] = {"slow_steps": 0}

    def _on_slow(self, ev: Dict) -> None:
        self.counters["slow_steps"] += 1
        if self.hooks.on_slow:
            self.hooks.on_slow(ev)

    def _flush(self, pending: List) -> None:
        """Fetch a window of device metrics in one transfer and run the host
        bookkeeping. The fetch waits until every step of the window has run
        on the card, so (now - window start) / len(window) is the true
        amortized per-step wall time."""
        if not pending:
            return
        fetched = fetch_metrics([m for _, m in pending])
        dt = (time.monotonic() - self._window_t0) / len(pending)
        for (i, _), metrics in zip(pending, fetched):
            timing = self.watchdog.record(i, dt)
            loss = float(metrics["loss"])
            for s in self.spike_detector.observe(i, loss):
                if self.hooks.on_spike:
                    self.hooks.on_spike(s)
            if "rms" in metrics:
                self.rms_monitor.record(i, metrics["rms"])
            rec = {"step": i, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]),
                   "n_skipped": int(metrics["n_skipped_tensors"]),
                   "dt": timing["dt"], "slow": timing["slow"]}
            self.history.append(rec)
            if self.hooks.on_step:
                self.hooks.on_step(i, rec)
            if self.log_every and i % self.log_every == 0:
                print(f"[trainer] step {i} loss {loss:.4f} "
                      f"gnorm {rec['grad_norm']:.3f} dt {timing['dt']*1e3:.0f}ms"
                      + (" SLOW" if timing["slow"] else ""))
        pending.clear()
        self._window_t0 = time.monotonic()

    def run(self, batch_iter, n_steps: int) -> List[Dict]:
        """Take ``n_steps`` steps. ``batch_iter``: an iterator of
        ``(data_index, batch)`` or a function of the step returning a batch
        (or ``(data_index, batch)``). Metrics stay on the card until a flush
        (every ``log_every`` steps, and at the end)."""
        start = int(self.state.step)
        pending: List = []
        self._window_t0 = time.monotonic()
        for i in range(start, start + n_steps):
            if hasattr(batch_iter, "__next__"):
                _, batch = next(batch_iter)
            else:
                out = batch_iter(i)
                batch = out[1] if isinstance(out, tuple) and len(out) == 2 else out
            self.state, metrics = self.step_fn(self.state, batch)
            pending.append((i, metrics))
            if not self.log_every or i % self.log_every == 0:
                self._flush(pending)
        self._flush(pending)
        return self.history

    def stability_report(self, layer: Optional[str] = None) -> Dict[str, Any]:
        spikes = self.spike_detector.spike_steps()
        report: Dict[str, Any] = {"loss_spike_steps": spikes,
                                  "counters": dict(self.counters)}
        for name in ([layer] if layer else self.rms_monitor.layers()):
            report[name] = self.rms_monitor.predicts_loss_spike(name, spikes)
        return report
