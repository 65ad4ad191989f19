"""Deterministic fault injection for the training loop: the port of
``repro/train/faults.py`` (same plans, same firing rules, same bits).

A ``FaultPlan`` is a list of ``FaultSpec``s, each firing when a chosen
step (or checkpoint save) is reached.  The injection sites are all *host*
boundaries — batch construction, the post-step state/metrics hand-off,
checkpoint writes — so the train step itself is untouched and the
production path (``fault_plan=None``) is byte-identical to before.

Fault kinds
-----------

``nan_grad`` / ``inf_grad``
    Simulates a non-finite gradient step: after the real step executes,
    every float param leaf is multiplied by NaN/Inf on its device (no host
    sync) and the reported ``grad_norm`` tensor goes non-finite.  The
    damage is persistent: every subsequent loss is NaN until someone
    rewinds, exactly the failure the supervisor exists for.

``explode_grad``
    Multiplies params by ``scale`` (default 8.0) and the reported
    grad_norm by 1e6 — a finite blow-up whose loss stays elevated for many
    steps (the paper's §3.4 spike shape).

``poison_batch``
    Shuffles the batch's integer ``labels`` leaf with
    ``np.random.RandomState(data_idx)`` (the JAX package's permutation) or,
    when there are no labels (CLIP's batches), scales the float leaves by
    1e4 — a bad data window flowing through the *real* datapath.  Keyed by
    data index, so the supervisor's skip-the-window recovery makes it
    unreachable by construction.

``fail_save`` / ``corrupt_ckpt`` / ``truncate_ckpt``
    Consumed by ``FaultyCheckpointManager``: the write for checkpoint step
    ``step`` raises an IOError (async-worker failure), or completes and
    then has one leaf bit-flipped / truncated (silent storage corruption /
    torn write), or loses its META.json with a stray ``.tmp`` left behind
    (crash mid-rename).

``crash``
    Raises ``SimulatedCrash`` from the trainer loop after the step is
    dispatched — exercises the auto-resume path end to end.

Keying and refire semantics
---------------------------

``key="data"`` (default) matches the *data index* the trainer consumed —
after a supervisor rewind-and-skip the index is never fed again, so the
fault cannot refire (a data-dependent failure).  ``key="step"`` matches
the step counter and refires on re-execution unless ``once=True`` — a
sticky step-keyed fault is how tests drive the escalation ladder to
abort; ``once=True`` models a transient hardware glitch.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.params import tree_map

BATCH_KINDS = ("poison_batch",)
STATE_KINDS = ("nan_grad", "inf_grad", "explode_grad")
CKPT_KINDS = ("fail_save", "corrupt_ckpt", "truncate_ckpt")
CRASH_KINDS = ("crash",)
ALL_KINDS = BATCH_KINDS + STATE_KINDS + CKPT_KINDS + CRASH_KINDS


class SimulatedCrash(RuntimeError):
    """Injected process death; only a fresh process (auto-resume) survives
    it — the supervisor deliberately does not catch it."""

    def __init__(self, step: int):
        super().__init__(f"simulated crash at step {step}")
        self.step = step


@dataclasses.dataclass
class FaultSpec:
    step: int                        # data index / step / checkpoint step
    kind: str                        # one of ALL_KINDS
    key: str = "data"                # "data" | "step" (ckpt kinds ignore it)
    once: bool = True                # fire at most once (transient fault)
    scale: float = 8.0               # explode_grad param multiplier
    fired: int = 0                   # times this spec has fired

    def __post_init__(self):
        if self.kind not in ALL_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {ALL_KINDS}")
        if self.key not in ("data", "step"):
            raise ValueError(f"fault key must be 'data' or 'step', "
                             f"got {self.key!r}")


@dataclasses.dataclass
class FaultPlan:
    faults: List[FaultSpec] = dataclasses.field(default_factory=list)

    @classmethod
    def from_json(cls, src: str) -> "FaultPlan":
        """Build from a JSON list (inline string or a file path):
        ``[{"step": 12, "kind": "nan_grad"}, ...]``."""
        if os.path.exists(src):
            with open(src) as f:
                raw = json.load(f)
        else:
            raw = json.loads(src)
        return cls([FaultSpec(**spec) for spec in raw])

    def _match(self, idx: int, kinds, key: str) -> Optional[FaultSpec]:
        for f in self.faults:
            if (f.kind in kinds and f.step == idx and f.key == key
                    and not (f.once and f.fired)):
                f.fired += 1
                return f
        return None

    def fired_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.faults:
            out[f.kind] = out.get(f.kind, 0) + f.fired
        return out

    # ------------------------------------------------------ injection sites
    def apply_batch(self, data_idx: int, batch):
        """Batch-level faults; keyed by data index only."""
        if self._match(data_idx, BATCH_KINDS, "data") is None:
            return batch
        rs = np.random.RandomState(data_idx)
        out = dict(batch)
        if "labels" in out:
            labels = out["labels"]
            host = (labels.cpu().numpy() if isinstance(labels, torch.Tensor)
                    else np.asarray(labels))
            perm = rs.permutation(host.ravel()).reshape(host.shape)
            out["labels"] = (torch.as_tensor(perm, dtype=labels.dtype, device=labels.device)
                             if isinstance(labels, torch.Tensor) else perm)
        else:
            out = {k: (v * 1e4 if _is_float(v) else v) for k, v in out.items()}
        return out

    def apply_post_step(self, step: int, data_idx: int, state, metrics):
        """State/metrics faults applied after the real step executed, on
        the device: every float param leaf and the reported ``grad_norm``
        multiplied (no host sync)."""
        spec = (self._match(data_idx, STATE_KINDS, "data")
                or self._match(step, STATE_KINDS, "step"))
        if spec is None:
            return state, metrics
        if spec.kind == "nan_grad":
            mul, gnorm = float("nan"), float("nan")
        elif spec.kind == "inf_grad":
            mul, gnorm = float("inf"), float("inf")
        else:                                     # explode_grad
            mul, gnorm = spec.scale, 1e6
        params = tree_map(lambda p: p * mul if p.is_floating_point() else p,
                          state.params)
        metrics = dict(metrics)
        metrics["grad_norm"] = metrics["grad_norm"] * gnorm
        return state._replace(params=params), metrics

    def maybe_crash(self, step: int):
        if self._match(step, CRASH_KINDS, "step") is not None:
            raise SimulatedCrash(step)

    # ------------------------------------------------- checkpoint corruption
    def corrupt_checkpoint_dir(self, directory: str, step: int):
        """Post-write corruption of a completed checkpoint directory."""
        d = os.path.join(directory, f"step_{step:08d}")
        spec = self._match(step, ("corrupt_ckpt", "truncate_ckpt"), "step") \
            or self._match(step, ("corrupt_ckpt", "truncate_ckpt"), "data")
        if spec is None or not os.path.isdir(d):
            return
        if spec.kind == "truncate_ckpt":
            # crash mid-rename: META gone, stray .tmp half-written
            os.makedirs(d + ".tmp", exist_ok=True)
            meta = os.path.join(d, "META.json")
            if os.path.exists(meta):
                os.remove(meta)
            return
        leaves = sorted(fn for fn in os.listdir(d) if fn.endswith(".npy"))
        if not leaves:
            return
        target = os.path.join(d, leaves[step % len(leaves)])
        with open(target, "r+b") as f:
            data = bytearray(f.read())
            if len(data) > 80:                    # flip bits past the header
                data[-8] ^= 0xFF
                f.seek(0)
                f.write(data)
            else:                                 # tiny leaf: truncate it
                f.truncate(max(len(data) // 2, 1))


class FaultyCheckpointManager(CheckpointManager):
    """CheckpointManager that consults a FaultPlan at write time — a
    ``fail_save`` raises from the (possibly async) worker, a
    ``corrupt_ckpt``/``truncate_ckpt`` damages the finished directory."""

    def __init__(self, directory: str, keep_last: int = 3, *,
                 plan: Optional[FaultPlan] = None, shardings=None):
        super().__init__(directory, keep_last, shardings)
        self.plan = plan

    def _write(self, step: int, host_tree, extra):
        if self.plan is not None and \
                self.plan._match(step, ("fail_save",), "step") is not None:
            raise IOError(f"injected write failure for step {step}")
        super()._write(step, host_tree, extra)
        if self.plan is not None:
            self.plan.corrupt_checkpoint_dir(self.directory, step)


def make_checkpoint_manager(directory: str, keep_last: int, plan: Optional[FaultPlan],
                            shardings=None) -> CheckpointManager:
    if plan is None:
        return CheckpointManager(directory, keep_last, shardings)
    return FaultyCheckpointManager(directory, keep_last, plan=plan, shardings=shardings)


def _is_float(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    return np.issubdtype(np.asarray(v).dtype, np.floating)
