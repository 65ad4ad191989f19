"""Serving launcher — continuously-batched decode through the ServeEngine.

The PyTorch counterpart of ``repro/launch/serve.py``: the same flags and
summary lines, plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions of the kernels). Like the JAX launcher it serves the
arch's reduced config with random weights. ``--kernel-backend``,
``--mesh`` and ``--devices`` are not here: the port dispatches on the
device of its tensors and runs on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --quant-mode int8_switchback --max-batch 4 --n-requests 8 --new-tokens 16
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ALL_ARCHS, get_reduced_config
from repro_torch.configs.base import ServeConfig
from repro_torch.models import build
from repro_torch.serve import make_serve_engine


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
                    help="paged: not ported yet (raises)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=0)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=0)
    ap.add_argument("--preemption", default="off", choices=("off", "recompute"))
    ap.add_argument("--spec-mode", default="off", choices=("off", "ngram"),
                    help="ngram: not ported yet (raises)")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--spec-ngram", type=int, default=3)
    ap.add_argument("--spec-min-ngram", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

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
    engine = make_serve_engine(build(cfg), scfg, device=args.device)
    params = engine.init_params(args.seed)
    print(f"[serve] {args.arch} device {engine.device} "
          f"{args.quant_mode} — {scfg.max_batch}x{scfg.max_len} ring cache")

    rng = np.random.default_rng(args.seed)
    lens = rng.integers(max(args.prompt_len // 2, 1),
                        args.prompt_len + args.prompt_len // 2 + 1,
                        size=args.n_requests)
    lens = np.minimum(lens, args.max_len)    # scheduler rejects > max_len
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]

    engine.generate(params, prompts, max_new_tokens=2)      # warm-up
    gens, stats = engine.generate(params, prompts,
                                  max_new_tokens=args.new_tokens)
    print(f"[serve] {stats['new_tokens']} new tokens "
          f"({stats['prefill_tokens']} prefilled) in "
          f"{stats['wall_s']:.2f}s — {stats['tokens_per_s']:.0f} tok/s, "
          f"{stats['decode_steps']} decode steps, "
          f"{stats['prefill_calls']} prefill calls; "
          f"ttft p50 {stats['ttft_p50_s']*1e3:.1f}ms, "
          f"itl p50 {stats['itl_p50_s']*1e3:.2f}ms (decode-only; "
          f"wall p95 {stats['itl_wall_p95_s']*1e3:.2f}ms, "
          f"prefill-stall p95 {stats['prefill_stall_p95_s']*1e3:.2f}ms)")
    print("sample:", gens[0][:12])


if __name__ == "__main__":
    main()
