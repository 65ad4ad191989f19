"""Training launcher: the port of ``repro/launch/train.py``. Every run
goes through the sharded ``TrainEngine``, as in the JAX launcher; one
process is a world of one (a degenerate (1, 1) mesh).

Like the JAX launcher it trains the arch's reduced config on synthetic
batches (``BigramLM``; ``SyntheticCLIP`` for ``--arch clip-vit-huge``;
``SyntheticSeq2Seq`` frames and targets for an enc-dec arch; a frontend
arch's tokens with its stub features, ``extra_embeds``),
with random weights, through ``make_engine`` and ``Trainer``, and prints
the mesh line, the per-step log, the final loss and the stability report
(rank 0 only). ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions) is new. As the JAX launcher does, it trains with
``remat="block"`` (each block recomputed in the backward), and
``--quant-mode`` takes every mode, ``fp16`` and ``fp32`` with the bf16
compute dtype of ``QuantPolicy.from_train_config`` (f32 products under
``fp32``); ``--optimizer adafactor`` runs AdaFactor; ``--loss-scaler`` is
``none``, ``fixed_tensor`` (the paper's §3.6 tensor-level skip at a fixed
scale) or ``dynamic`` (the whole-network skip and halving baseline).
Before it builds anything it turns off TF32 and the reduced-precision
reductions of 16-bit GEMMs (``core/precision.full_precision_products``).
As in the JAX launcher, ``--ckpt-dir`` checkpoints every
``max(steps // 3, 10)`` steps and resumes from the newest valid
checkpoint, ``--supervise`` runs under the self-healing
``TrainSupervisor``, ``--fault-plan`` injects faults, and
``--telemetry``/``--profile-steps`` record the flight recorder's JSONL
events and a ``torch.profiler`` Chrome trace (rank 0's).

Sharding (the data axes): ``--mesh auto|test|single|multi`` picks the
mesh over the ranks (``launch/mesh.py``), ``--fsdp`` shards parameters and
optimizer state over data (ZeRO-3), ``--pure-dp`` folds the ``model``
axis into data. A ``model`` axis above 1 without ``--pure-dp`` raises
``NotImplementedError`` (tensor parallelism, ROADMAP.md Queue 1 #13).
``--devices N`` with ``--device cpu`` starts N gloo ranks on this host;
on the card, start one process per card with ``torchrun``.
``--kernel-backend`` is accepted and raises (the port dispatches on the
device of its tensors).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 20 --quant-mode int8_switchback --device cuda
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 3 --device cpu --devices 4 --pure-dp --fsdp
    # the mixture of experts (the reduced qwen3-moe-30b-a3b; each rank's
    # tokens its dispatch group, the aux loss's means global)
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \
        --steps 3 --device cpu --devices 2 --fsdp
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch clip-vit-huge --steps 5 --batch 32 --fsdp
    PYTHONPATH=src python -m repro_torch.launch.train --arch clip-vit-huge \
        --steps 3 --batch 4 --quant-mode fp8_mixed --fp8-block 64 64 \
        --fp8-fallback-ratio 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --steps 30 \
        --ckpt-dir /tmp/ck --supervise \
        --fault-plan '[{"step": 12, "kind": "nan_grad"}]' \
        --telemetry /tmp/run.jsonl --profile-steps 3:4 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ALL_ARCHS, get_reduced_config
from repro_torch.configs.base import (CLIPConfig, ParallelConfig, SupervisorConfig,
                                      TelemetryConfig, TrainConfig)
from repro_torch.core.precision import QuantPolicy, full_precision_products
from repro_torch.data import BigramLM, SyntheticCLIP, SyntheticSeq2Seq
from repro_torch.launch.mesh import cli_mesh_shape, init_distributed, make_cli_mesh, \
    spawn_cpu_ranks
from repro_torch.models import build
from repro_torch.models import params as PRM
from repro_torch.models.frontends import synthetic_frontend_batch
from repro_torch.telemetry import Telemetry, parse_profile_steps
from repro_torch.train import FaultPlan, Trainer, make_engine
from repro_torch.train.engine import n_partitioned, require_data_axes

# flag -> why the port does not take it
UNPORTED = {
    "kernel_backend": "nothing: the port dispatches on the device of its tensors",
}


def _on(device, b: dict) -> dict:
    """A numpy batch as tensors on ``device``: integer entries as int64
    (token ids), float ones as they are."""
    return {k: torch.from_numpy(v).to(device=device,
                                      dtype=torch.long if v.dtype.kind in "iu" else None)
            for k, v in b.items()}


def make_data(cfg, batch: int, seq: int, device, seed: int = 0):
    """Step -> batch on ``device``. For a CLIPConfig SyntheticCLIP
    image-text pairs (32 classes, no class ids); for an enc-dec config
    SyntheticSeq2Seq's frames (``cfg.frontend_tokens`` of them), tokens
    and labels; else BigramLM tokens, with a frontend config's
    ``extra_embeds`` (B, frontend_tokens, d_model) bf16 beside them. The
    same streams as the JAX launcher's for the same config, but for the
    frontend features: the JAX launcher draws them with
    ``jax.random.normal(PRNGKey(i))``, which torch cannot replay; here
    numpy's generator seeded ``(seed, i)`` draws them
    (``models/frontends.synthetic_frontend_batch``)."""
    if isinstance(cfg, CLIPConfig):
        c = SyntheticCLIP(cfg.image_size, cfg.text_ctx, cfg.text_vocab, n_classes=32)

        def clip_fn(i):
            b = c.batch(batch)
            return _on(device, {k: b[k] for k in ("images", "texts")})
        return clip_fn
    if cfg.family == "encdec":
        s2s = SyntheticSeq2Seq(cfg.d_model, cfg.vocab_size)
        return lambda i: _on(device, s2s.batch(batch, cfg.frontend_tokens, seq))
    d = BigramLM(cfg.vocab_size, temperature=0.2)

    def fn(i):
        b = _on(device, d.batch(batch, seq))
        if cfg.frontend:
            b["extra_embeds"] = synthetic_frontend_batch(np.random.default_rng((seed, i)), cfg,
                                                         batch, device=device)
        return b
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
    ap.add_argument("--fp8-block", type=int, nargs=2, default=(128, 128),
                    metavar=("ROWS", "COLS"),
                    help="fp8_mixed blockwise-quantization tile shape")
    ap.add_argument("--fp8-fallback-ratio", type=float, default=8.0,
                    help="fp8_mixed: tile absmax > ratio x median falls "
                         "back to bf16 (lower = more conservative)")
    ap.add_argument("--attn-impl", default="flash_scan", choices=("flash_scan", "dense"))
    ap.add_argument("--optimizer", default="stable_adamw",
                    help="stable_adamw, adamw or adafactor")
    ap.add_argument("--beta2", type=float, default=0.95)
    ap.add_argument("--loss-scaler", default="none",
                    help="fixed_tensor: the paper's fixed scale with a per-tensor skip of "
                         "Inf/NaN gradients (§3.6); dynamic: the whole-network skip, the "
                         "scale halved on overflow (the baseline); none: no scaling")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--supervise", action="store_true",
                    help="run under the self-healing TrainSupervisor (anomaly "
                         "detection -> verified-checkpoint rewind -> data skip); needs "
                         "--ckpt-dir. The synthetic stream here, as in the JAX "
                         "launcher, ignores the data index, so a skip does not give "
                         "the exact shifted stream")
    ap.add_argument("--fault-plan", default=None,
                    help="inject faults: JSON list (inline or a file path) of "
                         '{"step", "kind", ...} specs; see repro_torch/train/faults.py '
                         "for kinds")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="supervisor: rewinds per incident before abort")
    ap.add_argument("--mesh", default="auto", choices=("auto", "test", "single", "multi"))
    ap.add_argument("--devices", type=int, default=None,
                    help="with --device cpu: start this many gloo ranks on this host "
                         "(on the card, start one process a card with torchrun)")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard params/moments over data too (ZeRO-3)")
    ap.add_argument("--pure-dp", action="store_true",
                    help="fold the model axis into data parallelism")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="write flight-recorder JSONL events here (read with "
                         "python -m repro_torch.telemetry.report)")
    ap.add_argument("--profile-steps", default=None, metavar="A:B",
                    help="wrap steps A..B (inclusive) in a torch.profiler trace "
                         "(a Chrome trace written under --profile-dir)")
    ap.add_argument("--profile-dir", default="/tmp/repro-profile")
    for flag in UNPORTED:
        ap.add_argument("--" + flag.replace("_", "-"), default=None,
                        help=f"not ported: {UNPORTED[flag]}")
    args = ap.parse_args(argv)
    for flag, why in UNPORTED.items():
        if getattr(args, flag) is not None:
            raise NotImplementedError(f"--{flag.replace('_', '-')} is not ported ({why})")

    if args.supervise and not args.ckpt_dir:
        ap.error("--supervise needs --ckpt-dir (rewind is the recovery primitive)")
    dev = PRM.resolve_device(args.device)
    if args.devices is not None and dev.type != "cpu":
        raise ValueError("--devices N starts N gloo ranks with --device cpu; on the card start "
                         "one process a card: torchrun --nproc-per-node N")
    spawn = (args.devices is not None and not dist.is_initialized()
             and "WORLD_SIZE" not in os.environ)
    world = (args.devices if spawn else dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    # the layout's check before any rank starts: a model axis above 1
    # without --pure-dp is tensor parallelism (Queue 1 #13)
    shape, axes = cli_mesh_shape(args.mesh, world)
    require_data_axes(ParallelConfig(mesh_shape=shape, mesh_axes=axes, pure_dp=args.pure_dp))
    if spawn:
        spawn_cpu_ranks(args.devices, _run, (args,))
        return
    started = init_distributed(dev)
    try:
        _run(args)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args):
    """One rank's run (the process group is up); ranks past 0 print nothing."""
    if dist.get_rank() == 0:
        _train(args, True)
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        _train(args, False)


def _train(args, rank0: bool):
    full_precision_products()
    dev = PRM.resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_reduced_config(args.arch)
    bundle = build(cfg)
    mesh = make_cli_mesh(args.mesh)
    par = ParallelConfig(mesh_shape=mesh.mesh_shape, mesh_axes=mesh.axis_names,
                         fsdp=args.fsdp, pure_dp=args.pure_dp, remat="block",
                         attn_impl=args.attn_impl)
    tc = TrainConfig(optimizer=args.optimizer, learning_rate=args.lr,
                     warmup_steps=max(args.steps // 10, 1), total_steps=args.steps,
                     beta2=args.beta2, loss_scaler=args.loss_scaler,
                     quant_mode=args.quant_mode, fp8_block_rows=args.fp8_block[0],
                     fp8_block_cols=args.fp8_block[1],
                     fp8_fallback_ratio=args.fp8_fallback_ratio,
                     microbatch_steps=args.microbatch)
    policy = QuantPolicy.from_train_config(tc)
    data_fn = make_data(cfg, args.batch, args.seq, dev, args.seed)
    # the batch spec is the stream's first batch, as the JAX launcher takes it
    engine = make_engine(bundle, tc, par, mesh, data_fn(0), policy=policy)
    state = engine.init_state(seed=args.seed)
    n_split, n_leaves = n_partitioned(engine)
    n_params = sum(math.prod(s.shape) for s in PRM.tree_leaves(bundle.param_specs))
    print(f"[train] mesh {mesh.shape} fsdp={par.fsdp} pure_dp={par.pure_dp} — "
          f"{n_split}/{n_leaves} param tensors partitioned, step donated")
    print(f"[train] {cfg.name} on {dev}: {n_params / 1e6:.2f} M params, quant_mode "
          f"{args.quant_mode}, attn_impl {args.attn_impl}, {args.optimizer}, "
          f"batch {args.batch} x {args.seq}, microbatch {args.microbatch}")
    if policy.mode == "fp8_mixed":
        print(f"[train] fp8_mixed tile {policy.fp8_block_rows} x {policy.fp8_block_cols}, "
              f"fallback ratio {policy.fp8_fallback_ratio:g}")

    plan = FaultPlan.from_json(args.fault_plan) if args.fault_plan else None
    ckpt_every = max(args.steps // 3, 10) if args.ckpt_dir else 0
    tele = Telemetry.from_config(
        TelemetryConfig(path=args.telemetry if rank0 else None,
                        profile_steps=parse_profile_steps(args.profile_steps) if rank0 else None,
                        profile_dir=args.profile_dir),
        program="train",
        meta={"arch": args.arch, "quant_mode": args.quant_mode, "device": str(dev),
              "optimizer": args.optimizer, "steps": args.steps,
              "supervised": bool(args.supervise), "mesh": mesh.shape})
    try:
        if args.supervise:
            sup = engine.make_supervisor(
                state, data_fn, checkpoint_dir=args.ckpt_dir,
                config=SupervisorConfig(checkpoint_every=ckpt_every,
                                        max_retries=args.max_retries),
                fault_plan=plan, telemetry=tele)
            start = sup.maybe_resume()
            sup.run(args.steps - start)
            trainer = sup.trainer
        else:
            trainer = Trainer(engine.step, state, checkpoint_dir=args.ckpt_dir,
                              checkpoint_every=ckpt_every, log_every=10,
                              state_shardings=engine.state_shardings,
                              fault_plan=plan, telemetry=tele)
            start = trainer.maybe_resume()
            trainer.run(lambda i: engine.shard_batch(data_fn(i)), args.steps - start)
            sup = None
    finally:
        tele.close()
    if trainer.history:
        print("final loss:", trainer.history[-1]["loss"])
        print("stability:", (sup or trainer).stability_report())
    else:
        print(f"nothing to do: resumed at step {start} >= --steps {args.steps}")
    if args.telemetry:
        print(f"[telemetry] events written to {args.telemetry} — summarize with: "
              f"python -m repro_torch.telemetry.report {args.telemetry}")


if __name__ == "__main__":
    main()
