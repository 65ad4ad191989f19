"""LR schedules (``repro/optim/schedules.py``). The paper's recipe: linear
warmup (5k of 20k iterations), then cosine decay (§2.2.2 / §3.2).

Each schedule maps the step (a tensor) to an f32 tensor on its device,
in f32 arithmetic throughout, dividing tensor by tensor as JAX does."""
from __future__ import annotations

import math

import torch

from repro_torch.core.quantization import div


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_lr: float = 0.0):
    def sched(step):
        step = _f32(step)
        warm = div(peak_lr * step, max(1.0, warmup_steps))
        prog = div(step - warmup_steps, max(1.0, total_steps - warmup_steps))
        prog = torch.clamp(prog, 0.0, 1.0)
        cos = final_lr + 0.5 * (peak_lr - final_lr) * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def warmup_constant(peak_lr: float, warmup_steps: int):
    def sched(step):
        step = _f32(step)
        warm = div(peak_lr * step, max(1.0, warmup_steps))
        return torch.where(step < warmup_steps, warm, torch.full_like(warm, peak_lr))
    return sched


def beta2_warmup(lam: float = 0.5):
    """AdaFactor/PaLM-style β₂(t) = 1 − t^(−λ). The paper found it does not
    help (Fig. 15); kept so the benchmark can reproduce that."""
    def sched(step):
        t = torch.clamp_min(_f32(step), 1.0)
        return 1.0 - t ** (-lam)
    return sched
