"""ServeEngine: continuously-batched int8 inference on one card.

The PyTorch counterpart of ``repro/serve/engine.py`` in ring mode:

  * a preallocated **ring KV cache** of shape (max_batch, max_len) per
    layer with per-slot lengths (``models/transformer.init_serve_state``),
    updated in place by every step;
  * a **prefill** that seeds admitted slots' caches from pow2-bucketed
    prompt batches without touching live neighbours, and a **decode step**
    (one token for every slot);
  * the **SlotScheduler** loop (``generate``) that keeps the decode batch
    full: FIFO admission into free slots, eviction on EOS / token budget /
    cache edge.

With ``quant_mode="int8_switchback"`` every transformer linear runs the
SwitchBack int8 forward through the CUDA kernels of
``kernels/switchback``. There is no jit, no mesh and no donation: each
step runs eagerly on the engine's device.

Not in this slice (raising ``NotImplementedError``): the paged cache,
chunked prefill, preemption and speculative decoding, the flight
recorder, and ``attn_impl="flash_scan"`` (the flash kernels, next slice).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN_IMPLS, ParallelConfig, ServeConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.models import params as PRM
from repro_torch.models import transformer as TF
from repro_torch.models.common import rope_tables
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.telemetry.registry import MetricsRegistry

#: supervisor counters in the stats row (zero: no training supervisor
#: runs beside the port's engine yet; kept so the row's keys match the
#: JAX engine's)
SUPERVISOR_KEYS = ("rewinds", "data_steps_skipped", "incidents",
                   "escalations", "save_failures", "save_retries")


def prefill_bucket(n: int, lo: int = 8) -> int:
    """Pad size for a prefill batch: smallest power of two >= max(n, lo).

    >>> prefill_bucket(1)
    8
    >>> prefill_bucket(9)
    16
    >>> prefill_bucket(16)
    16
    """
    b = max(int(lo), 1)
    while b < n:
        b *= 2
    return b


def _make_sample_fn(temperature: float):
    """(B, V) logits -> (B,) int64 tokens. Greedy is argmax, first index
    on ties. With ``temperature > 0`` slot b's draw comes from a
    ``torch.Generator`` seeded with (seed, uid[b], step[b]), so request
    i's step-j token is one fixed function of the seed, whatever the
    batching. The draws cannot match the JAX engine's (threefry
    ``fold_in`` keys); only greedy decoding is token-for-token equal."""
    if temperature > 0:
        def sample_fn(logits, seed, uids, steps):
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            out = torch.empty(logits.shape[0], dtype=torch.long,
                              device=logits.device)
            for b in range(logits.shape[0]):
                g = torch.Generator(device=logits.device)
                g.manual_seed((seed * 1_000_003 + int(uids[b])) * 1_000_003
                              + int(steps[b]))
                out[b] = torch.multinomial(probs[b], 1, generator=g)[0]
            return out
    else:
        def sample_fn(logits, seed, uids, steps):
            return torch.argmax(logits, dim=-1)
    return sample_fn


class ServeEngine:
    """One decode service for a decoder-only LM on one device. Build with
    :func:`make_serve_engine`. The high-level entry point is
    :meth:`generate`; :meth:`prefill` / :meth:`decode` / :meth:`sample`
    are the raw steps for tests and custom loops."""

    def __init__(self, bundle, serve_cfg: ServeConfig, parallel: ParallelConfig,
                 policy: QuantPolicy, device="cuda"):
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.serve_cfg = serve_cfg
        self.parallel = parallel
        self.policy = policy
        self.device = PRM.resolve_device(device)
        self.specs = bundle.param_specs
        self.cache_dtype = getattr(torch, serve_cfg.cache_dtype)
        # RoPE tables hoisted to engine constants (rows for positions
        # [0, max_len)), bit-identical to on-the-fly RoPE. With rollover
        # positions pass max_len, so RoPE is computed per call instead.
        self.rope = (None if serve_cfg.rollover else
                     rope_tables(self.cfg.hd, self.cfg.rope_theta,
                                 serve_cfg.max_len, self.device))
        self._sample = _make_sample_fn(serve_cfg.temperature)

    def init_cache(self):
        """Fresh all-zero serve state on the engine's device."""
        return TF.init_serve_state(self.cfg, self.serve_cfg.max_batch,
                                   self.serve_cfg.max_len, self.cache_dtype,
                                   self.device)

    def init_params(self, seed: int = 0):
        """Random parameters from a torch.Generator seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return PRM.init_params(self.specs, gen, device=self.device)

    # -- raw steps ----------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, params, cache, tokens, prompt_lens, admit):
        """Seed admitted slots from padded prompts. tokens: (max_batch, S)
        int right-padded prompts; prompt_lens: (max_batch,); admit:
        (max_batch,) bool. Returns ``(logits (B, 1, V), cache)`` — each
        slot's last valid prompt position. Only admitted slots' cache rows
        and lengths change."""
        dev = self.device
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev)
        lens = torch.as_tensor(np.asarray(prompt_lens), dtype=torch.int32, device=dev)
        admit = torch.as_tensor(np.asarray(admit), dtype=torch.bool, device=dev)
        S = tokens.shape[1]
        rc = None if self.rope is None else (self.rope[0][:S], self.rope[1][:S])
        return TF.serve_prefill(params, cache, tokens, lens, admit, self.cfg,
                                self.policy, self.parallel, last_only=True,
                                rope_cache=rc)

    @torch.inference_mode()
    def decode(self, params, cache, tokens):
        """One decode step for every slot: tokens (max_batch, 1) ->
        ``(logits (B, 1, V), cache)``. Every slot's length advances by one
        (empty slots decode garbage that admission later overwrites)."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                 device=self.device)
        rc = None
        if self.rope is not None:
            # lengths advance in lockstep across layers: group 0's row is
            # this step's positions. Idle slots can run past max_len (their
            # garbage is evicted by admission): clamp the gather, as JAX's
            # clamping gather does.
            pos = next(iter(cache.values())).length[0].long()
            pos = pos.clamp(max=self.serve_cfg.max_len - 1)
            rc = (self.rope[0][pos][:, None], self.rope[1][pos][:, None])
        return TF.decode_step(params, cache, tokens, self.cfg, self.policy,
                              self.parallel, rope_cache=rc)

    def sample(self, logits, uids, steps, seed: Optional[int] = None) -> np.ndarray:
        """Next tokens (B,) as numpy from last-position logits (B, V) with
        the engine's temperature (0 = greedy argmax). ``uids``/``steps``
        (B,) make temperature > 0 draws a function of (seed, request uid,
        generation step); ``seed`` defaults to ``ServeConfig.seed``."""
        seed = self.serve_cfg.seed if seed is None else seed
        return self._sample(logits, seed, uids, steps).cpu().numpy()

    # -- the serving loop ---------------------------------------------------
    def _stats_registry(self) -> MetricsRegistry:
        """The stats-row schema of the JAX ring engine, declared once; the
        empty and the measured path snapshot this same registry."""
        reg = MetricsRegistry()
        for k in ("new_tokens", "prefill_tokens", "decode_steps",
                  "prefill_calls", "prefill_chunks"):
            reg.counter(k)
        for k in ("wall_s", "prefill_s", "decode_s", "tokens_per_s",
                  "decode_tokens_per_s"):
            reg.gauge(k)
        for name in ("ttft", "itl", "itl_wall", "prefill_stall"):
            reg.histogram(name, percentiles=(50, 95), suffix="_s")
        reg.gauge("tokens_per_model_pass")
        for k in SlotScheduler(self.serve_cfg.max_batch,
                               self.serve_cfg.max_len).counters:
            reg.counter(f"sched_{k}")
        for k in SUPERVISOR_KEYS:
            reg.counter(f"supervisor_{k}")
        return reg

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, params, prompts: Sequence[Sequence[int]], *,
                 max_new_tokens=32, eos_id: Optional[int] = None,
                 stop: Optional[Sequence] = None,
                 seed: Optional[int] = None
                 ) -> Tuple[List[List[int]], Dict[str, float]]:
        """Continuously-batched generation for a list of prompts.

        ``max_new_tokens`` is one int or one per request; ``stop`` an
        optional per-request stop spec (``scheduler.normalize_stop``);
        ``seed`` overrides ``ServeConfig.seed`` for temperature > 0.
        A request with a non-positive budget returns ``[]``.

        Loops: admit queued requests into free slots, run one bucketed
        prefill over the admitted slots, decode one token for the whole
        batch, record and evict finished sequences. Returns
        ``(generations, stats)`` with the JAX ring engine's stats keys:
        tokens/s, TTFT, decode-only and wall inter-token latency,
        prefill stall, scheduler counters."""
        scfg = self.serve_cfg
        B = scfg.max_batch
        if isinstance(max_new_tokens, (int, np.integer)):
            budgets = [int(max_new_tokens)] * len(prompts)
        else:
            budgets = [int(m) for m in max_new_tokens]
            if len(budgets) != len(prompts):
                raise ValueError(f"{len(budgets)} max_new_tokens entries "
                                 f"for {len(prompts)} prompts")
        if stop is not None and len(stop) != len(prompts):
            raise ValueError(f"{len(stop)} stop entries for "
                             f"{len(prompts)} prompts")
        if not any(m >= 1 for m in budgets):
            return [[] for _ in prompts], self._stats_registry().snapshot()
        reg = self._stats_registry()
        h_ttft, h_itl = reg.histogram("ttft"), reg.histogram("itl")
        h_itl_wall = reg.histogram("itl_wall")
        h_stall = reg.histogram("prefill_stall")
        sched = SlotScheduler(B, scfg.max_len, rollover=scfg.rollover)
        uids: List[Optional[int]] = [None] * len(prompts)
        for i, p in enumerate(prompts):
            if budgets[i] >= 1:
                uids[i] = sched.submit(p, max_new_tokens=budgets[i],
                                       eos_id=eos_id,
                                       stop=None if stop is None else stop[i])
        cache = self.init_cache()
        cur = np.zeros((B,), np.int64)          # next input token per slot
        n_new = n_prefill_tok = n_steps = n_prefills = n_chunks = 0
        n_decoded = n_slot_passes = 0
        prefill_s = decode_s = 0.0
        ttft: Dict[int, float] = {}
        stall: Dict[int, float] = {}
        last_t: Dict[int, float] = {}

        self._sync()
        t0 = time.perf_counter()
        while sched.has_work:
            sched.admit()                   # ring: whole prompts, cursor 0
            prefilling = sched.prefilling
            if prefilling:
                t_pf = time.perf_counter()
                decoding = [s for s, _ in sched.running]
                chunks = {s: len(r.context) - r.prefilled for s, r in prefilling}
                # the bucket may round past a non-pow2 max_len; the
                # scheduler guarantees every prompt fits the cache
                S = min(prefill_bucket(max(chunks.values()),
                                       scfg.prefill_bucket), scfg.max_len)
                toks = np.zeros((B, S), np.int64)
                toks_l = np.ones((B,), np.int32)   # dummy 1 for idle slots
                mask = np.zeros((B,), bool)
                uids_a = np.zeros((B,), np.int64)
                steps_a = np.zeros((B,), np.int64)
                for slot, r in prefilling:
                    c = chunks[slot]
                    toks[slot, :c] = r.context[:c]
                    toks_l[slot] = c
                    mask[slot] = True
                    uids_a[slot] = r.uid
                    steps_a[slot] = len(r.generated)
                logits, cache = self.prefill(params, cache, toks, toks_l, mask)
                tok = self.sample(logits[:, 0], uids_a, steps_a, seed)
                now = time.perf_counter()
                dur = now - t_pf
                for slot, r in prefilling:
                    r.prefilled += chunks[slot]
                    # prompt resident: first token from the last position
                    done = sched.record(slot, tok[slot])
                    cur[slot] = tok[slot]
                    if r.uid not in ttft:
                        ttft[r.uid] = now - t0
                    last_t[slot] = now
                    n_new += 1
                    if done:
                        last_t.pop(slot, None)
                        stall.pop(slot, None)
                for slot in decoding:
                    # the prefill sat between two of this slot's tokens
                    stall[slot] = stall.get(slot, 0.0) + dur
                n_prefill_tok += int(sum(chunks.values()))
                n_chunks += len(prefilling)
                n_prefills += 1
                prefill_s += dur
            running = sched.running
            if not running:
                continue
            t_dec = time.perf_counter()
            logits, cache = self.decode(params, cache, cur[:, None])
            uids_a = np.zeros((B,), np.int64)
            steps_a = np.zeros((B,), np.int64)
            for slot, r in running:
                uids_a[slot] = r.uid
                steps_a[slot] = len(r.generated)
            tok = self.sample(logits[:, 0], uids_a, steps_a, seed)
            now = time.perf_counter()
            for slot, r in running:
                done = sched.record(slot, tok[slot])
                cur[slot] = tok[slot]
                delta = now - last_t[slot]
                stalled = stall.pop(slot, 0.0)
                h_itl_wall.observe(delta)
                h_itl.observe(max(delta - stalled, 0.0))
                if stalled:
                    h_stall.observe(stalled)
                last_t[slot] = now
                if done:
                    last_t.pop(slot, None)
                    stall.pop(slot, None)
            n_new += len(running)
            n_decoded += len(running)
            n_slot_passes += len(running)
            n_steps += 1
            decode_s += now - t_dec
        dt = time.perf_counter() - t0

        h_ttft.observe_many(ttft[u] for u in uids if u in ttft)
        reg.counter("new_tokens").set(n_new)
        reg.counter("prefill_tokens").set(n_prefill_tok)
        reg.counter("decode_steps").set(n_steps)
        reg.counter("prefill_calls").set(n_prefills)
        reg.counter("prefill_chunks").set(n_chunks)
        reg.gauge("wall_s").set(dt)
        reg.gauge("prefill_s").set(prefill_s)
        reg.gauge("decode_s").set(decode_s)
        reg.gauge("tokens_per_s").set(n_new / max(dt, 1e-9))
        reg.gauge("decode_tokens_per_s").set(n_decoded / max(decode_s, 1e-9))
        reg.gauge("tokens_per_model_pass").set(
            n_decoded / max(n_slot_passes, 1))
        reg.fill_counters(sched.counters, prefix="sched_")
        stats = reg.snapshot()
        # itl is wall-minus-stall per sample; the bucketed estimator can
        # invert the order by one bucket width, so pin it at the row level
        for p in (50, 95):
            stats[f"itl_p{p}_s"] = min(stats[f"itl_p{p}_s"],
                                       stats[f"itl_wall_p{p}_s"])
        return [[] if u is None else sched.results[u] for u in uids], stats


def _only_defaults(cfg, names, why: str):
    """Raise on a field of a later slice set to other than its default,
    rather than ignore it."""
    defaults = {f.name: f.default for f in dataclasses.fields(cfg)}
    for name in names:
        if getattr(cfg, name) != defaults[name]:
            raise NotImplementedError(
                f"{type(cfg).__name__}.{name}={getattr(cfg, name)!r}: {why}; "
                f"this slice takes only the default {defaults[name]!r}")


def make_serve_engine(model, serve_cfg: ServeConfig, *,
                      parallel: Optional[ParallelConfig] = None,
                      policy: Optional[QuantPolicy] = None,
                      device="cuda") -> ServeEngine:
    """Assemble the serving stack for ``model`` on ``device``.

    ``model`` is an arch name, a ModelConfig or a ModelBundle (dense
    decoder-only LMs). ``device`` defaults to the card; on a host without
    one this raises unless ``device="cpu"`` is asked for. ``policy``
    defaults to ``serve_cfg.quant_mode``.

    ``parallel`` defaults to ``ParallelConfig(remat="none",
    attn_impl="dense")``. The JAX engine defaults to ``flash_scan``, which
    on its Pallas backends runs the flash-attention kernels; those kernels
    are the next slice of the port, and until they land asking for
    ``flash_scan`` raises rather than quietly computing plain attention
    where the JAX package would run a kernel. The JAX default returns with
    that slice.
    """
    from repro_torch.models import build
    if isinstance(model, str):
        from repro_torch.configs import get_config
        model = get_config(model)
    bundle = model if hasattr(model, "param_specs") else build(model)
    parallel = parallel or ParallelConfig(remat="none", attn_impl="dense")
    flash_tiles = "flash-attention tile sizes: the flash kernels arrive with port slice 2"
    _only_defaults(parallel, ("attn_block_q", "attn_block_k"), flash_tiles)
    _only_defaults(serve_cfg, ("attn_block_q", "attn_block_k"), flash_tiles)
    _only_defaults(serve_cfg, ("block_size", "num_blocks", "prefix_cache"),
                   "paged-cache settings: the paged cache is not ported yet")
    _only_defaults(serve_cfg, ("spec_k", "spec_ngram", "spec_min_ngram"),
                   "speculative-decoding settings: not ported yet")
    if parallel.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {parallel.attn_impl!r} not in {ATTN_IMPLS}")
    if parallel.attn_impl != "dense":
        raise NotImplementedError(
            "attn_impl='flash_scan' runs the flash-attention kernels "
            "(flash_fwd, decode_fwd), which arrive with port slice 2; use "
            "ParallelConfig(attn_impl='dense')")
    if serve_cfg.cache_mode not in ("ring", "paged"):
        raise ValueError(f"cache_mode {serve_cfg.cache_mode!r} not in "
                         "('ring', 'paged')")
    if serve_cfg.cache_mode == "paged" or serve_cfg.spec_mode != "off":
        raise NotImplementedError(
            "the paged cache and speculative decoding are not ported yet "
            "(the paged-serving slice, ROADMAP.md Queue 1); use "
            "cache_mode='ring', spec_mode='off'")
    if serve_cfg.prefill_chunk_tokens or serve_cfg.preemption != "off":
        raise NotImplementedError(
            "prefill_chunk_tokens / preemption are paged-cache features: "
            "the ring cache has no block table to chunk against or park into")
    policy = policy or QuantPolicy(serve_cfg.quant_mode)
    return ServeEngine(bundle, serve_cfg, parallel, policy, device)
