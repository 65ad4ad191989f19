"""Serving launcher — continuously-batched decode through the ServeEngine.

The PyTorch counterpart of ``repro/launch/serve.py``: the same flags and
summary lines, plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions of the kernels). Like the JAX launcher it serves the
arch's reduced config with random weights, and an arch the engine cannot
serve (SSM and hybrid stacks: recurrent state, not a KV cache; a
multimodal frontend, whose text it decodes) through
``decode_step_fallback``, a batched greedy ``decode_step`` loop; an
enc-dec or CLIP arch exits non-zero with the engine's reason, as in the
JAX launcher. ``--kernel-backend``, ``--mesh`` and ``--devices`` are not
here: the port dispatches on the
device of its tensors and runs on one card. Before it builds anything it
turns off TF32 and the reduced-precision reductions of 16-bit GEMMs
(``core/precision.full_precision_products``). ``--telemetry`` records the
measured ``generate`` call's flight-recorder events (not the warm-up),
``--profile-steps A:B`` wraps engine waves A..B in a ``torch.profiler``
Chrome trace under ``--profile-dir``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --quant-mode int8_switchback --max-batch 4 --n-requests 8 --new-tokens 16
    # the mixture of experts (reduced qwen3-moe-30b-a3b); fp16 serves the
    # bf16 computation (bf16 compute, as the JAX launcher builds the policy),
    # fp32 f32 linears on the bf16-rounded weights
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
        --quant-mode fp32 --device cpu
    # the paged cache, chunked prefill, preemption, n-gram drafts
    PYTHONPATH=src python -m repro_torch.launch.serve --cache-mode paged \
        --prefill-chunk-tokens 8 --preemption recompute --spec-mode ngram
    # SSM and hybrid stacks and a vision-language backbone (no engine
    # path): the batched decode_step loop, text only for the latter
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --quant-mode int8_switchback --max-batch 4 --prompt-len 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-76b --device cpu
    # the flight recorder: events, then the summary
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --telemetry /tmp/serve.jsonl --profile-steps 2:3
    PYTHONPATH=src python -m repro_torch.telemetry.report /tmp/serve.jsonl
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_reduced_config
from repro_torch.configs.base import ParallelConfig, ServeConfig
from repro_torch.core.precision import QuantPolicy, full_precision_products
from repro_torch.models import build
from repro_torch.models import params as PRM
from repro_torch.models import transformer as TF
from repro_torch.serve import make_serve_engine
from repro_torch.telemetry import Telemetry, parse_profile_steps


def decode_step_fallback(cfg, args, *, reason: str, params=None):
    """Batched greedy decode through ``decode_step`` for archs the
    ServeEngine cannot serve (recurrent state instead of a KV cache; a
    frontend stack, of which it decodes the text), as the JAX launcher's
    fallback (an enc-dec or CLIP arch exits with ``reason``): one fixed
    batch of ``args.max_batch`` seeded prompts of ``args.prompt_len``
    tokens fed one token a step, then ``args.new_tokens`` greedy tokens a
    row; no continuous batching.
    The prompts come from numpy's generator seeded ``args.seed + 1`` (the
    JAX launcher draws from its own PRNG), the weights from
    ``init_params(args.seed)`` unless ``params`` are given. Returns
    {"tokens": (B, new_tokens) int64, "prompts", "tokens_per_s",
    "decode_s", "new_tokens"}."""
    if getattr(cfg, "family", "") in ("clip", "encdec"):
        raise SystemExit(f"--arch {args.arch}: {reason}")
    print(f"[serve] {args.arch}: no engine path ({reason}); "
          "falling back to the decode_step loop")
    dev = PRM.resolve_device(args.device)
    pol = QuantPolicy(args.quant_mode)
    par = ParallelConfig(remat="none")
    if params is None:
        params = PRM.init_params(build(cfg).param_specs, args.seed, device=dev)
    B = args.max_batch
    state = TF.init_decode_state(cfg, B, args.prompt_len + args.new_tokens, device=dev)
    rng = np.random.default_rng(args.seed + 1)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, args.prompt_len))).to(dev)

    def step(tok):
        return TF.decode_step(params, state, tok, cfg, pol, par)[0]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        logits = None
        for t in range(args.prompt_len):                # stepwise "prefill"
            logits = step(prompts[:, t:t + 1])
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        toks = [tok]
        sync()
        t0 = time.perf_counter()
        for _ in range(args.new_tokens - 1):
            tok = torch.argmax(step(tok)[:, -1], -1)[:, None]
            toks.append(tok)
        sync()
        dt = time.perf_counter() - t0
    n = B * (args.new_tokens - 1)
    print(f"[serve] {n} new tokens in {dt:.2f}s ({n / max(dt, 1e-9):.0f} "
          f"tok/s, {args.quant_mode}, batch {B}, no continuous batching)")
    return {"tokens": torch.cat(toks, dim=1), "prompts": prompts,
            "tokens_per_s": n / max(dt, 1e-9), "decode_s": dt, "new_tokens": n}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ALL_ARCHS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode-batch slots (continuous batching width)")
    ap.add_argument("--max-len", type=int, default=128,
                    help="ring KV cache cells per slot")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="synthetic prompt length (requests vary +/- 50%%)")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--quant-mode", default="bf16")
    ap.add_argument("--attn-block-q", type=int, default=0)
    ap.add_argument("--attn-block-k", type=int, default=0)
    ap.add_argument("--cache-mode", default="ring", choices=("ring", "paged"),
                    help="paged = block-pool KV cache + radix prefix cache + "
                         "the block-table attention kernels")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged: tokens per physical KV block")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="paged: pool size; 0 = auto (ring-equivalent capacity "
                         "max_batch*ceil(max_len/block_size))")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="paged: do not park finished requests' blocks for "
                         "shared-prefix reuse")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=0,
                    help="paged: per-step token budget for chunked prefill; long "
                         "prompts prefill in slices that share the step with "
                         "decodes (0 = monolithic)")
    ap.add_argument("--preemption", default="off", choices=("off", "recompute"),
                    help="paged: when the block pool runs dry mid-decode, park the "
                         "newest request's blocks to the prefix cache and requeue it")
    ap.add_argument("--spec-mode", default="off", choices=("off", "ngram"),
                    help="paged + greedy: n-gram speculative decoding, drafts "
                         "verified in one paged-prefill pass")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="spec: max drafted tokens per slot per step")
    ap.add_argument("--spec-ngram", type=int, default=3,
                    help="spec: longest history n-gram to match")
    ap.add_argument("--spec-min-ngram", type=int, default=2,
                    help="spec: shortest n-gram worth a verify pass")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="write flight-recorder JSONL events here (read with "
                         "python -m repro_torch.telemetry.report); only the measured "
                         "generate() call is recorded, not the warm-up")
    ap.add_argument("--profile-steps", default=None, metavar="A:B",
                    help="wrap engine waves A..B (inclusive) in a torch.profiler trace")
    ap.add_argument("--profile-dir", default="/tmp/repro-profile")
    args = ap.parse_args(argv)

    full_precision_products()
    cfg = get_reduced_config(args.arch)
    scfg = ServeConfig(max_batch=args.max_batch, max_len=args.max_len,
                       temperature=args.temperature,
                       quant_mode=args.quant_mode,
                       attn_block_q=args.attn_block_q,
                       attn_block_k=args.attn_block_k,
                       cache_mode=args.cache_mode,
                       block_size=args.block_size,
                       num_blocks=args.num_blocks,
                       prefix_cache=not args.no_prefix_cache,
                       prefill_chunk_tokens=args.prefill_chunk_tokens,
                       preemption=args.preemption,
                       spec_mode=args.spec_mode, spec_k=args.spec_k,
                       spec_ngram=args.spec_ngram,
                       spec_min_ngram=args.spec_min_ngram, seed=args.seed)
    try:
        engine = make_serve_engine(build(cfg), scfg, device=args.device)
    except TF.NoEnginePath as e:
        # SSM, hybrid and frontend archs have no engine path; they serve
        # through the one-token decode_step loop, and enc-dec and CLIP exit
        # with the reason, as in the JAX launcher. The port's other
        # refusals (flags it does not take) still raise.
        return decode_step_fallback(cfg, args, reason=str(e))
    params = engine.init_params(args.seed)
    cache_desc = (f"{engine.num_blocks}x{scfg.block_size} paged blocks"
                  if scfg.cache_mode == "paged"
                  else f"{scfg.max_batch}x{scfg.max_len} ring cache")
    print(f"[serve] {args.arch} device {engine.device} "
          f"{args.quant_mode} — {cache_desc}")

    rng = np.random.default_rng(args.seed)
    lens = rng.integers(max(args.prompt_len // 2, 1),
                        args.prompt_len + args.prompt_len // 2 + 1,
                        size=args.n_requests)
    lens = np.minimum(lens, args.max_len)    # scheduler rejects > max_len
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]

    engine.generate(params, prompts, max_new_tokens=2)      # warm-up
    tele = Telemetry(args.telemetry, profile_steps=parse_profile_steps(args.profile_steps),
                     profile_dir=args.profile_dir, program="serve",
                     meta={"arch": args.arch, "quant_mode": args.quant_mode,
                           "cache_mode": args.cache_mode, "spec_mode": args.spec_mode,
                           "n_requests": args.n_requests})
    engine.telemetry = tele
    try:
        gens, stats = engine.generate(params, prompts, max_new_tokens=args.new_tokens)
    finally:
        tele.close()
    print(f"[serve] {stats['new_tokens']} new tokens "
          f"({stats['prefill_tokens']} prefilled) in "
          f"{stats['wall_s']:.2f}s — {stats['tokens_per_s']:.0f} tok/s, "
          f"{stats['decode_steps']} decode steps, "
          f"{stats['prefill_calls']} prefill calls; "
          f"ttft p50 {stats['ttft_p50_s']*1e3:.1f}ms, "
          f"itl p50 {stats['itl_p50_s']*1e3:.2f}ms (decode-only; "
          f"wall p95 {stats['itl_wall_p95_s']*1e3:.2f}ms, "
          f"prefill-stall p95 {stats['prefill_stall_p95_s']*1e3:.2f}ms)")
    if scfg.cache_mode == "paged":
        print(f"[serve] paged: {stats['prefix_hits']}/"
              f"{stats['prefix_lookups']} prefix hits, "
              f"{stats['prefill_tokens_saved']} prefill tokens saved, "
              f"peak {stats['peak_blocks_in_use']} blocks "
              f"({stats['peak_cache_bytes']/1e6:.2f} MB vs "
              f"{stats['ring_equiv_cache_bytes']/1e6:.2f} MB ring)")
        if scfg.prefill_chunk_tokens or scfg.preemption != "off":
            print(f"[serve] slo: {stats['prefill_chunks']} prefill chunks "
                  f"over {stats['prefill_calls']} calls, "
                  f"{stats['sched_preempted']} preemptions")
        if scfg.spec_mode != "off":
            print(f"[serve] spec: {stats['spec_accepted']}/"
                  f"{stats['spec_drafted']} drafts accepted "
                  f"({stats['spec_acceptance_rate']:.2f}) over "
                  f"{stats['spec_verify_calls']} verify calls — "
                  f"{stats['tokens_per_model_pass']:.2f} tokens per "
                  f"model pass")
    print("sample:", gens[0][:12])
    if args.telemetry:
        print(f"[telemetry] events written to {args.telemetry} — summarize with: "
              f"python -m repro_torch.telemetry.report {args.telemetry}")


if __name__ == "__main__":
    main()
