"""Training launcher: the port of ``repro/launch/train.py`` on one card.

Like the JAX launcher it trains the arch's reduced config on ``BigramLM``
batches, with random weights, through ``make_train_setup``,
``make_train_step`` and ``Trainer``, and prints the per-step log, the
final loss and the stability report. ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions) is new. Training runs with
``remat="none"``. The flags of what is not ported yet are accepted and
raise ``NotImplementedError``: the mesh and sharding flags, the
supervisor, fault injection, checkpoints, the flight recorder and its
profiler window, and ``--kernel-backend`` (the port dispatches on the
device of its tensors).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 20 --quant-mode int8_switchback --device cuda
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ALL_ARCHS, get_reduced_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.data import BigramLM
from repro_torch.models import build
from repro_torch.models import params as PRM
from repro_torch.train import Trainer, init_train_state, make_train_setup, make_train_step

# flag -> the ROADMAP.md item that brings it
UNPORTED = {
    "mesh": "sharded training (Queue 1 #4)",
    "devices": "sharded training (Queue 1 #4)",
    "fsdp": "sharded training (Queue 1 #4)",
    "pure_dp": "sharded training (Queue 1 #4)",
    "supervise": "self-healing training (Queue 1 #7)",
    "max_retries": "self-healing training (Queue 1 #7)",
    "fault_plan": "self-healing training (Queue 1 #7)",
    "ckpt_dir": "checkpoint/manager.py (Queue 1 #3)",
    "telemetry": "the flight recorder (Queue 1 #7)",
    "profile_steps": "the flight recorder (Queue 1 #7)",
    "profile_dir": "the flight recorder (Queue 1 #7)",
    "kernel_backend": "nothing: the port dispatches on the device of its tensors",
}


def make_data(cfg, batch: int, seq: int, device):
    """Step -> BigramLM batch on ``device`` (the same stream as the JAX
    launcher's for the same vocabulary and seed)."""
    d = BigramLM(cfg.vocab_size, temperature=0.2)

    def fn(i):
        return {k: torch.from_numpy(v).to(device=device, dtype=torch.long)
                for k, v in d.batch(batch, seq).items()}
    return fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ALL_ARCHS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--quant-mode", default="bf16")
    ap.add_argument("--attn-impl", default="flash_scan", choices=("flash_scan", "dense"))
    ap.add_argument("--optimizer", default="stable_adamw")
    ap.add_argument("--beta2", type=float, default=0.95)
    ap.add_argument("--loss-scaler", default="none")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    for flag in UNPORTED:
        store_true = flag in ("fsdp", "pure_dp", "supervise")
        ap.add_argument("--" + flag.replace("_", "-"), default=None,
                        action="store_true" if store_true else "store",
                        help=f"not ported yet: {UNPORTED[flag]}")
    args = ap.parse_args(argv)
    for flag, item in UNPORTED.items():
        if getattr(args, flag) not in (None, False):
            raise NotImplementedError(f"--{flag.replace('_', '-')} is not ported yet "
                                      f"({item}; ROADMAP.md)")

    dev = PRM.resolve_device(args.device)
    cfg = get_reduced_config(args.arch)
    bundle = build(cfg)
    par = ParallelConfig(remat="none", attn_impl=args.attn_impl)
    tc = TrainConfig(optimizer=args.optimizer, learning_rate=args.lr,
                     warmup_steps=max(args.steps // 10, 1), total_steps=args.steps,
                     beta2=args.beta2, loss_scaler=args.loss_scaler,
                     quant_mode=args.quant_mode, microbatch_steps=args.microbatch)
    policy = QuantPolicy(tc.quant_mode)
    opt, scaler = make_train_setup(tc)
    step = make_train_step(bundle, policy, par, tc, opt, scaler)
    params = PRM.init_params(bundle.param_specs, args.seed, device=dev)
    state = init_train_state(params, opt, scaler)
    n_params = sum(p.numel() for p in PRM.tree_leaves(params))
    print(f"[train] {cfg.name} on {dev}: {n_params / 1e6:.2f} M params, quant_mode "
          f"{args.quant_mode}, attn_impl {args.attn_impl}, {args.optimizer}, "
          f"batch {args.batch} x {args.seq}, microbatch {args.microbatch}")

    data_fn = make_data(cfg, args.batch, args.seq, dev)
    trainer = Trainer(step, state, log_every=10)
    trainer.run(data_fn, args.steps)
    if trainer.history:
        print("final loss:", trainer.history[-1]["loss"])
        print("stability:", trainer.stability_report())


if __name__ == "__main__":
    main()
