"""TrainSupervisor: online anomaly detection → rewind-and-skip recovery.
The port of ``repro/train/supervisor.py``: the same detection, rewind
ladder, skip, escalation and report.

The paper's stability analysis (§3.4 / App. D) shows loss spikes are
*predictable and recoverable*: they strike 1–8 iterations after the AdamW
second moment goes stale, and the era's production mitigation was to
restore an earlier checkpoint and skip the offending data window.  The
supervisor automates exactly that around the existing Trainer:

  detect    non-finite loss / grad norm, grad-norm explosion or loss jump
            vs a running EMA, and *confirmed* loss spikes via the
            incremental ``LossSpikeDetector.observe`` — all at the
            trainer's flush granularity, on metrics it already fetches;
  rewind    restore the newest checkpoint that passes crc verification at
            or before the fault (the trainer's host bookkeeping — history,
            spike detector, RMS monitor — rolls back with it);
  skip      advance the data cursor past the fault window.  The pipeline
            is a pure function of the data index, so the skip is
            deterministic and the post-recovery stream is exactly the
            clean stream shifted by the skipped window;
  escalate  a fault that re-fires in the same region rewinds one
            checkpoint earlier and skips wider, up to
            ``max_retries`` per incident and ``max_total_rewinds``
            overall, then raises ``TrainingAborted`` with the full report.

A failed async checkpoint write (``CheckpointWriteError``) is not a
training anomaly: the supervisor counts it and retries the save
synchronously at the boundary instead of rewinding.

Simulated crashes (``faults.SimulatedCrash``) are deliberately NOT caught:
only a fresh process — ``maybe_resume`` — survives a process death.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional

from repro_torch.checkpoint import CheckpointWriteError
from repro_torch.configs.base import SupervisorConfig
from repro_torch.telemetry import as_telemetry
from repro_torch.train.trainer import Trainer, TrainerHooks
from repro_torch.train.train_step import TrainState


class TrainingAborted(RuntimeError):
    """Recovery budget exhausted (or no valid checkpoint to rewind to)."""

    def __init__(self, reason: str, report: Dict):
        super().__init__(f"training aborted: {reason}")
        self.reason = reason
        self.report = report


class _Anomaly(Exception):
    """Internal control flow: raised from the trainer's hooks, caught by
    the supervisor's run loop."""

    def __init__(self, step: int, kind: str, detail: str):
        super().__init__(f"{kind} at step {step}: {detail}")
        self.step = step
        self.kind = kind
        self.detail = detail


def _finite(x: float) -> bool:
    return math.isfinite(x)


class TrainSupervisor:
    """Wraps a Trainer with detect → rewind → skip → escalate recovery.

    ``data_fn(j)`` must be a pure function of the data index ``j`` (the
    repo-wide pipeline contract); the supervisor owns the step→data-index
    mapping ``j = step + data_offset`` and grows the offset on recovery.
    As in the JAX package it is built through the sharded engine
    (``TrainEngine.make_supervisor``, which passes ``state_shardings``),
    or directly over a train step. Under the engine every rank runs one:
    detection reads the global metrics (the loss and grad norm the step
    reduced over the ranks, equal on every rank), so every rank rewinds
    and skips together.
    """

    def __init__(self, step_fn: Callable, state: TrainState,
                 data_fn: Callable[[int], Dict], *,
                 checkpoint_dir: str,
                 config: Optional[SupervisorConfig] = None,
                 fault_plan=None,
                 hooks: Optional[TrainerHooks] = None,
                 watch_layers=("patch_embed", "embed"),
                 state_shardings=None,
                 telemetry=None):
        self.config = cfg = config or SupervisorConfig()
        if not checkpoint_dir or cfg.checkpoint_every <= 0:
            raise ValueError("TrainSupervisor needs a checkpoint_dir and "
                             "checkpoint_every >= 1: rewind is the recovery "
                             "primitive")
        self.data_fn = data_fn
        self.data_offset = 0
        self.telemetry = as_telemetry(telemetry)
        self._user_hooks = hooks or TrainerHooks()
        self.trainer = Trainer(
            step_fn, state, checkpoint_dir=checkpoint_dir,
            checkpoint_every=cfg.checkpoint_every,
            keep_checkpoints=cfg.keep_checkpoints,
            watch_layers=watch_layers, log_every=cfg.log_every,
            fault_plan=fault_plan,
            state_shardings=state_shardings,
            telemetry=telemetry,
            hooks=TrainerHooks(on_step=self._on_step,
                               on_checkpoint=self._user_hooks.on_checkpoint,
                               on_spike=self._on_spike,
                               on_slow=self._user_hooks.on_slow))
        det = self.trainer.spike_detector
        det.z_threshold = cfg.spike_z
        det.min_history = cfg.spike_min_history
        # detection EMAs (rebuilt from surviving history on rollback)
        self._loss_ema: Optional[float] = None
        self._gnorm_ema: Optional[float] = None
        self._n_obs = 0
        # recovery bookkeeping
        self._region_end = -1        # fault step of the open incident
        self._attempt = 0
        self.rewind_log: List[Dict] = []
        self.counters: Dict[str, int] = {
            "rewinds": 0, "data_steps_skipped": 0, "incidents": 0,
            "escalations": 0, "save_failures": 0, "save_retries": 0}
        self.incident_kinds: Dict[str, int] = {}

    # -------------------------------------------------------------- detection
    def _ema_update(self, loss: float, gnorm: float) -> None:
        a = 0.1
        if _finite(loss):
            self._loss_ema = loss if self._loss_ema is None else \
                (1 - a) * self._loss_ema + a * loss
        if _finite(gnorm):
            self._gnorm_ema = gnorm if self._gnorm_ema is None else \
                (1 - a) * self._gnorm_ema + a * gnorm
        self._n_obs += 1

    def _on_spike(self, event_step: int) -> None:
        if self._user_hooks.on_spike:
            self._user_hooks.on_spike(event_step)
        raise _Anomaly(event_step, "loss_spike",
                       "confirmed loss-spike event (App. D criterion)")

    def _on_step(self, i: int, rec: Dict) -> None:
        if self._user_hooks.on_step:
            self._user_hooks.on_step(i, rec)
        cfg = self.config
        loss, gnorm = rec["loss"], rec["grad_norm"]
        if not _finite(loss) or not _finite(gnorm):
            raise _Anomaly(i, "nonfinite",
                           f"loss={loss} grad_norm={gnorm}")
        if self._n_obs >= cfg.detect_warmup:
            if gnorm > cfg.grad_norm_abs:
                raise _Anomaly(i, "grad_explosion",
                               f"grad_norm {gnorm:.3g} > abs ceiling "
                               f"{cfg.grad_norm_abs:.3g}")
            if self._gnorm_ema and gnorm > cfg.grad_norm_ratio * \
                    self._gnorm_ema:
                raise _Anomaly(i, "grad_explosion",
                               f"grad_norm {gnorm:.3g} > "
                               f"{cfg.grad_norm_ratio}x EMA "
                               f"{self._gnorm_ema:.3g}")
            if self._loss_ema and loss > cfg.loss_jump_ratio * self._loss_ema:
                raise _Anomaly(i, "loss_jump",
                               f"loss {loss:.3g} > {cfg.loss_jump_ratio}x "
                               f"EMA {self._loss_ema:.3g}")
        self._ema_update(loss, gnorm)

    # --------------------------------------------------------------- recovery
    def _batch_iter(self, i: int):
        j = i + self.data_offset
        return j, self.data_fn(j)

    def _rebuild_emas(self) -> None:
        self._loss_ema = self._gnorm_ema = None
        self._n_obs = 0
        for h in self.trainer.history:
            self._ema_update(h["loss"], h["grad_norm"])

    def _recover(self, a: _Anomaly) -> None:
        cfg, t = self.config, self.trainer
        self.telemetry.emit("anomaly", step=a.step, anomaly=a.kind,
                            detail=a.detail)
        t_rw = time.time()
        self.counters["rewinds"] += 1
        self.incident_kinds[a.kind] = self.incident_kinds.get(a.kind, 0) + 1
        if self.counters["rewinds"] > cfg.max_total_rewinds:
            raise TrainingAborted(
                f"global rewind budget {cfg.max_total_rewinds} exhausted "
                f"({a.kind} at step {a.step})", self.report())
        if a.step <= self._region_end:      # re-encountered the same region
            self._attempt += 1
            self.counters["escalations"] += 1
        else:                               # new incident
            self._attempt = 1
            self.counters["incidents"] += 1
        self._region_end = max(self._region_end, a.step)
        if self._attempt > cfg.max_retries:
            raise TrainingAborted(
                f"{a.kind} at step {a.step} survived {cfg.max_retries} "
                "rewinds", self.report())

        try:                                # drain any in-flight write; its
            t.ckpt.wait()                   # failure is counted, not fatal —
        except CheckpointWriteError as e:   # recovery supersedes it
            self.counters["save_failures"] += 1
            self.telemetry.emit("save_failure", step=int(e.step),
                                error=repr(e.__cause__))
        t._early_ckpt_wanted = False
        valid = t.ckpt.valid_steps(max_step=a.step)
        if not valid:
            raise TrainingAborted(
                f"no valid checkpoint at or before step {a.step}",
                self.report())
        # escalation ladder: attempt k rewinds to the k-th newest valid
        # checkpoint and skips (margin + (k-1) * widen) extra data steps
        restore_step = valid[max(len(valid) - self._attempt, 0)]
        start = t.restore_checkpoint(restore_step)
        t.rollback(start)
        self._rebuild_emas()
        skip = (a.step - start) + cfg.skip_margin + \
            (self._attempt - 1) * cfg.skip_widen
        self.data_offset += skip
        self.counters["data_steps_skipped"] += skip
        ev = {"fault_step": a.step, "kind": a.kind, "detail": a.detail,
              "restored_step": start, "attempt": self._attempt,
              "skipped": skip, "data_offset": self.data_offset}
        self.rewind_log.append(ev)
        # the rewind_log entry doubles as a trace span: the span covers
        # checkpoint drain + restore + host-state rollback
        dur = time.time() - t_rw
        self.telemetry.emit_span("rewind", t_rw, dur, step=a.step,
                                 anomaly=a.kind, restored_step=start,
                                 attempt=self._attempt, skipped=skip)
        self.telemetry.emit("rewind", step=a.step, anomaly=a.kind,
                            detail=a.detail, restored_step=start,
                            attempt=self._attempt, skipped=skip,
                            data_offset=self.data_offset)
        if cfg.log_every:
            print(f"[supervisor] {a.kind} at step {a.step}: rewound to "
                  f"step {start} (attempt {self._attempt}), skipping "
                  f"{skip} data steps (offset {self.data_offset})")

    def _retry_save(self, e: CheckpointWriteError) -> None:
        self.counters["save_failures"] += 1
        self.telemetry.emit("save_failure", step=int(e.step),
                            error=repr(e.__cause__))
        t = self.trainer
        if self.config.log_every:
            print(f"[supervisor] async checkpoint write for step {e.step} "
                  f"failed ({e.__cause__!r}); retrying synchronously")
        t.ckpt.save(int(t.state.step), t.state)   # raises if truly broken
        self.counters["save_retries"] += 1

    # -------------------------------------------------------------------- run
    def maybe_resume(self) -> int:
        return self.trainer.maybe_resume()

    def run(self, n_steps: int) -> List[Dict]:
        t = self.trainer
        start = int(t.state.step)
        end = start + n_steps
        if t.ckpt.latest_step() is None:    # rewind anchor for step ~0 faults
            t.ckpt.save(start, t.state)
        while int(t.state.step) < end:
            try:
                t.run(self._batch_iter, end - int(t.state.step))
            except _Anomaly as a:
                self._recover(a)
            except CheckpointWriteError as e:
                self._retry_save(e)
        t.ckpt.wait()
        return t.history

    # ----------------------------------------------------------------- report
    def report(self) -> Dict:
        last_restore = (self.rewind_log[-1]["restored_step"]
                        if self.rewind_log else None)
        spikes = self.trainer.spike_detector.spike_steps()
        return {**{k: v for k, v in self.counters.items()},
                "incident_kinds": dict(self.incident_kinds),
                "rewind_log": list(self.rewind_log),
                "data_offset": self.data_offset,
                "loss_spike_steps": spikes,
                "post_recovery_spikes":
                    [] if last_restore is None else
                    [s for s in spikes if s >= last_restore],
                "fault_plan_fired":
                    (self.trainer.fault_plan.fired_counts()
                     if self.trainer.fault_plan is not None else {})}

    def stability_report(self, layer: Optional[str] = None) -> Dict:
        rep = self.trainer.stability_report(layer)
        rep["supervisor"] = self.report()
        return rep
