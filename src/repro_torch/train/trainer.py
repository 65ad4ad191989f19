"""Host training loop with the fault-tolerance story: the port of
``repro/train/trainer.py``.

``Trainer.run`` steps the train step over a batch source, keeps the
metrics on the device between flush points and fetches a window of them
in one transfer (``fetch_metrics``); at each flush the host bookkeeping
runs: the straggler watchdog on the amortized step time, the loss-spike
detector and the per-tensor RMS_t monitor (paper §3.4 / App. D), the
history, the hooks and the flight recorder's events. Around it:

  * auto-resume from the newest *valid* checkpoint (``maybe_resume``;
    corrupt or mid-rename directories are skipped, the data resumes at the
    restored step because the pipeline is a pure function of the index),
  * async rotating checkpoints every ``checkpoint_every`` steps (atomic
    renames, per-leaf crc32; a failed async write surfaces as
    ``CheckpointWriteError`` at the next boundary, attributed to its step),
  * the straggler watchdog's early checkpoint on a slow step
    (``counters["early_checkpoints"]``),
  * deterministic fault injection (``fault_plan=``, default off) at three
    host sites: the batch, the state and metrics after the step, and a
    simulated crash (``train/faults.py``); recovery lives in
    ``train/supervisor.py``,
  * telemetry (``telemetry=``): ``train_step``, ``spike``, ``flush`` and
    ``checkpoint`` events, ``flush`` and ``checkpoint_save`` spans and the
    profiler window, built from values the flush already fetched.

``stability_report`` gives the App.-D RMS-spike -> loss-spike analysis.

With ``state_shardings`` (the sharded engine's) each rank runs its own
Trainer over its slice of the state: checkpoints hold whole leaves
(``checkpoint/manager.py``), a restore keeps this rank's slices, and the
one host decision that reads a rank's own clock, the straggler
watchdog's early checkpoint (a collective save), is taken when any rank
wants it, at the flush every rank makes at the same step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.distributed.straggler import StragglerWatchdog
from repro_torch.stability import LossSpikeDetector, RMSMonitor
from repro_torch.telemetry import as_telemetry
from repro_torch.telemetry.health import qh_items, summarize_rms
from repro_torch.train.faults import make_checkpoint_manager
from repro_torch.train.train_step import TrainState


@dataclasses.dataclass
class TrainerHooks:
    on_step: Optional[Callable[[int, Dict], None]] = None
    on_checkpoint: Optional[Callable[[int], None]] = None
    on_spike: Optional[Callable[[int], None]] = None
    on_slow: Optional[Callable[[Dict], None]] = None


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
                 checkpoint_every: int = 0, keep_checkpoints: int = 3,
                 watch_layers=("patch_embed", "embed"),
                 hooks: Optional[TrainerHooks] = None,
                 log_every: int = 10,
                 fault_plan=None,
                 early_checkpoint_on_slow: bool = True,
                 state_shardings=None,
                 telemetry=None):
        self.step_fn = train_step_fn
        self.telemetry = as_telemetry(telemetry)
        self.state = state
        self.state_shardings = state_shardings
        self.fault_plan = fault_plan
        self.ckpt = (make_checkpoint_manager(checkpoint_dir, keep_checkpoints, fault_plan,
                                             state_shardings)
                     if checkpoint_dir else None)
        self.checkpoint_every = checkpoint_every
        self.watchdog = StragglerWatchdog()
        self.watchdog.on_slow = self._on_slow
        self.rms_monitor = RMSMonitor(watch_layers=watch_layers)
        self.spike_detector = LossSpikeDetector(ignore_first=0)
        self.hooks = hooks or TrainerHooks()
        self.log_every = log_every
        self.history: List[Dict] = []
        self.early_checkpoint_on_slow = early_checkpoint_on_slow
        self.counters: Dict[str, int] = {"slow_steps": 0, "early_checkpoints": 0}
        self._early_ckpt_wanted = False
        self._last_saved_step: Optional[int] = None

    # ------------------------------------------------------------------
    def maybe_resume(self) -> int:
        """Restore the newest valid checkpoint if one exists; returns the
        start step. Corrupt or torn checkpoints are skipped (the manager
        falls back to the newest directory that verifies)."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return int(self.state.step)
        return self.restore_checkpoint()

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        """Load checkpoint ``step`` (default newest valid) into
        ``self.state`` on the state's device, the generator's state
        included (this rank's slices under ``state_shardings``); returns
        the restored step."""
        self.state, step, _ = self.ckpt.restore(step, like=self.state,
                                                device=self.state.step.device)
        return step

    # ------------------------------------------------------------------
    def _on_slow(self, ev: Dict) -> None:
        self.counters["slow_steps"] += 1
        self._early_ckpt_wanted = True
        if self.hooks.on_slow:
            self.hooks.on_slow(ev)

    def _flush(self, pending: List) -> None:
        """Fetch a window of device metrics in one transfer and run the host
        bookkeeping (spike detector, RMS monitor, watchdog, history, hooks,
        telemetry). The fetch waits until every step of the window has run
        on the card, so (now - window start) / len(window) is the true
        amortized per-step wall time."""
        if not pending:
            return
        tele = self.telemetry
        t_fl = time.time()
        fetched = fetch_metrics([m for _, m in pending])
        dt = (time.monotonic() - self._window_t0) / len(pending)
        for (i, _), metrics in zip(pending, fetched):
            timing = self.watchdog.record(i, dt)
            loss = float(metrics["loss"])
            for s in self.spike_detector.observe(i, loss):
                tele.emit("spike", step=int(s), observed_at=i)
                if self.hooks.on_spike:
                    self.hooks.on_spike(s)
            if "rms" in metrics:
                self.rms_monitor.record(i, metrics["rms"])
            rec = {"step": i, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]),
                   "n_skipped": int(metrics["n_skipped_tensors"]),
                   "dt": timing["dt"], "slow": timing["slow"]}
            if tele.enabled:
                ev = dict(rec, **qh_items(metrics))
                if "rms" in metrics:
                    ev.update(summarize_rms(metrics["rms"]))
                tele.emit("train_step", **ev)
            self.history.append(rec)
            if self.hooks.on_step:
                self.hooks.on_step(i, rec)
            if self.log_every and i % self.log_every == 0:
                print(f"[trainer] step {i} loss {loss:.4f} "
                      f"gnorm {rec['grad_norm']:.3f} dt {timing['dt']*1e3:.0f}ms"
                      + (" SLOW" if timing["slow"] else ""))
        # the flush span covers the one blocking fetch for the window: in a
        # Chrome trace, host sync time is this span
        tele.emit_span("flush", t_fl, time.time() - t_fl,
                       step=pending[-1][0], n_steps=len(pending))
        tele.emit("flush", step=pending[-1][0], n_steps=len(pending))
        pending.clear()
        if self.state_shardings is not None:
            self._early_ckpt_wanted = self.state_shardings.any(self._early_ckpt_wanted)
        self._window_t0 = time.monotonic()

    def _save(self, step: int) -> None:
        t_sv = time.time()
        self.ckpt.save_async(step, self.state)
        self._last_saved_step = step
        # the span times the synchronous device -> host snapshot inside
        # save_async (the write itself is off-thread)
        self.telemetry.emit_span("checkpoint_save", t_sv, time.time() - t_sv, step=step)
        self.telemetry.emit("checkpoint", step=step)
        if self.hooks.on_checkpoint:
            self.hooks.on_checkpoint(step)
        # the snapshot must not be billed to the next window's step timing
        self._window_t0 = time.monotonic()

    def run(self, batch_iter, n_steps: int) -> List[Dict]:
        """Take ``n_steps`` steps. ``batch_iter``: an iterator of
        ``(data_index, batch)`` or a function of the step returning a batch
        or ``(data_index, batch)``. Metrics stay on the card until a flush
        (every ``log_every`` steps, at each checkpoint and at the end)."""
        start = int(self.state.step)
        plan = self.fault_plan
        pending: List = []
        self._window_t0 = time.monotonic()
        for i in range(start, start + n_steps):
            self.telemetry.maybe_profile(i)
            if hasattr(batch_iter, "__next__"):
                data_idx, batch = next(batch_iter)
            else:
                out = batch_iter(i)
                data_idx, batch = out if (isinstance(out, tuple) and len(out) == 2) else (i, out)
            if plan is not None:
                batch = plan.apply_batch(data_idx, batch)
            self.state, metrics = self.step_fn(self.state, batch)
            if plan is not None:
                self.state, metrics = plan.apply_post_step(i, data_idx, self.state, metrics)
                plan.maybe_crash(i)
            pending.append((i, metrics))

            at_ckpt = (self.ckpt is not None and self.checkpoint_every
                       and (i + 1) % self.checkpoint_every == 0)
            if at_ckpt or not self.log_every or i % self.log_every == 0:
                self._flush(pending)
                if self.ckpt is not None:
                    # a failed async write surfaces here, at the next
                    # checkpoint/flush boundary, attributed to its step
                    self.ckpt.poll_error()
            if at_ckpt:
                self._save(i + 1)
            elif self._early_ckpt_wanted and self.early_checkpoint_on_slow \
                    and self.ckpt is not None and self.checkpoint_every:
                # straggler watchdog fired: bank progress now, at most one
                # early save per half checkpoint window
                self._flush(pending)
                if self._last_saved_step is None or \
                        i + 1 - self._last_saved_step >= max(self.checkpoint_every // 2, 1):
                    self._save(i + 1)
                    self.counters["early_checkpoints"] += 1
            self._early_ckpt_wanted = False
        self._flush(pending)
        if self.ckpt is not None:
            self.ckpt.wait()
        return self.history

    # ------------------------------------------------------------------
    def rollback(self, step: int) -> None:
        """Forget all host-side bookkeeping for steps >= ``step`` (the
        supervisor restored a checkpoint there; those steps re-execute)."""
        self.history = [h for h in self.history if h["step"] < step]
        self.spike_detector.rollback(step)
        self.rms_monitor.rollback(step)

    def stability_report(self, layer: Optional[str] = None) -> Dict[str, Any]:
        spikes = self.spike_detector.spike_steps()
        report: Dict[str, Any] = {"loss_spike_steps": spikes,
                                  "counters": dict(self.counters)}
        for name in ([layer] if layer else self.rms_monitor.layers()):
            report[name] = self.rms_monitor.predicts_loss_spike(name, spikes)
        return report
