"""ServeEngine: continuously-batched int8 inference on one card.

The PyTorch counterpart of ``repro/serve/engine.py``:

  * a preallocated **ring KV cache** of shape (max_batch, max_len) per
    layer with per-slot lengths (``models/transformer.init_serve_state``),
    updated in place by every step;
  * a **prefill** that seeds admitted slots' caches from pow2-bucketed
    prompt batches without touching live neighbours, and a **decode step**
    (one token for every slot);
  * the **SlotScheduler** loop (``generate``) that keeps the decode batch
    full: FIFO admission into free slots, eviction on EOS / token budget /
    cache edge.

``ServeConfig.cache_mode="paged"`` swaps the ring cache for the
**PagedServe** block pool: K/V live in a fixed pool of ``num_blocks``
blocks of ``block_size`` tokens, each slot carries a host-managed block
table (``serve/paged/block_pool.py``), identical prompt prefixes adopt
already-filled blocks through a radix prefix cache (no prefill for the
shared prefix), and attention runs the block-table kernels of
``kernels/paged_attention``. Cache memory then scales with live tokens
instead of ``max_batch × max_len``. On top of it: chunked prefill
(``prefill_chunk_tokens``: a fixed per-step token budget, so a long prompt
prefills across steps while its neighbours keep decoding), preempt-to-
queue (``preemption="recompute"``: admission stops reserving worst-case
blocks, and when decode growth finds the pool empty the newest request is
parked back to the radix cache and requeued), and n-gram speculative
decoding (``spec_mode="ngram"``: a prompt-lookup proposer drafts up to
``spec_k`` tokens per slot, one verify call through the paged prefill path
at Sq = spec_k + 1 scores them all, greedy acceptance keeps the longest
matching prefix plus one bonus token, and rejection truncates the block
table; tokens stay those of ``spec_mode="off"``).

With ``quant_mode="int8_switchback"`` every transformer linear runs the
SwitchBack int8 forward through the CUDA kernels of
``kernels/switchback``, and with the default ``attn_impl="flash_scan"``
attention runs the flash kernels of ``kernels/flash_attention`` (ring
prefill and decode) or the paged kernels (paged prefill, verify and
decode). There is no jit, no mesh and no donation: each step runs eagerly
on the engine's device.

Observability, as in the JAX engine: an optional ``telemetry`` flight
recorder (per-request lifecycle events, ``prefill_wave``/``verify_wave``/
``decode_wave`` spans and ``wave`` events, the ``serve_stats`` row, a
profiler window over waves) and an optional ``stability_source`` (a
``TrainSupervisor``, anything with ``report()``/``stability_report()``, or
a report dict) whose rewind/skip counters fill the stats row's
``supervisor_*`` keys. Neither touches the tokens.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN_IMPLS, ParallelConfig, ServeConfig, _only_defaults
from repro_torch.core.precision import QuantPolicy
from repro_torch.models import params as PRM
from repro_torch.models import transformer as TF
from repro_torch.models.common import rope_tables
from repro_torch.serve.paged import NoFreeBlocks, PagedCacheManager
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve.spec import NgramProposer
from repro_torch.telemetry import MetricsRegistry, as_telemetry

#: supervisor counters surfaced in the stats row (``stability_source``)
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
    (ring) and :meth:`prefill_paged` / :meth:`decode_paged` /
    :meth:`verify_paged` / :meth:`set_lengths` (paged) are the raw steps
    for tests and custom loops.

    Paged mode: ``num_blocks`` physical blocks (the trash block not
    counted), ``blocks_per_slot`` = cdiv(max_len, block_size) table width,
    ``block_bytes`` what one block costs across layers (K and V), and
    ``ring_equiv_cache_bytes`` what the ring cache would cost.

    ``telemetry`` (a :class:`~repro_torch.telemetry.Telemetry`) and
    ``stability_source`` are attributes, None by default, as in the JAX
    engine."""

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
        paged = serve_cfg.cache_mode == "paged"
        bs = serve_cfg.block_size
        self.blocks_per_slot = -(-serve_cfg.max_len // bs) if paged else 0
        # auto num_blocks = the ring cache's capacity in blocks, so the
        # default paged engine admits whatever the ring engine admits
        self.num_blocks = ((serve_cfg.num_blocks
                            or serve_cfg.max_batch * self.blocks_per_slot)
                           if paged else 0)
        # cache footprint for the stats row: one block across all layers
        # (K and V), and what the ring cache preallocates
        itemsize = torch.empty((), dtype=self.cache_dtype).element_size()
        per_token = 2 * self.cfg.n_layers * self.cfg.n_kv_heads * self.cfg.hd * itemsize
        self.block_bytes = per_token * bs if paged else 0
        self.ring_equiv_cache_bytes = (per_token * serve_cfg.max_batch
                                       * serve_cfg.max_len)
        self.telemetry = None
        self.stability_source = None

    def init_cache(self):
        """Fresh all-zero serve state on the engine's device: the ring cache,
        or the block pools under ``cache_mode="paged"``."""
        scfg = self.serve_cfg
        if scfg.cache_mode == "paged":
            return TF.init_paged_serve_state(self.cfg, self.num_blocks, scfg.block_size,
                                             scfg.max_batch, self.cache_dtype, self.device)
        return TF.init_serve_state(self.cfg, scfg.max_batch, scfg.max_len,
                                   self.cache_dtype, self.device)

    def init_params(self, seed: int = 0):
        """Random parameters from a torch.Generator seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return PRM.init_params(self.specs, gen, device=self.device)

    # -- raw steps ----------------------------------------------------------
    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _rope_rows(self, pos: torch.Tensor):
        """RoPE rows for absolute positions ``pos`` (any shape), clamped to
        the table as JAX's gather clamps (idle and pad rows run past it;
        their results are garbage that is never read)."""
        if self.rope is None:
            return None
        pos = pos.long().clamp(0, self.serve_cfg.max_len - 1)
        return self.rope[0][pos], self.rope[1][pos]

    @torch.inference_mode()
    def prefill(self, params, cache, tokens, prompt_lens, admit):
        """Seed admitted slots from padded prompts. tokens: (max_batch, S)
        int right-padded prompts; prompt_lens: (max_batch,); admit:
        (max_batch,) bool. Returns ``(logits (B, 1, V), cache)`` — each
        slot's last valid prompt position. Only admitted slots' cache rows
        and lengths change."""
        tokens = self._tensor(tokens, torch.long)
        lens = self._tensor(prompt_lens, torch.int32)
        admit = self._tensor(admit, torch.bool)
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
        tokens = self._tensor(tokens, torch.long)
        # lengths advance in lockstep across layers: group 0's row is this
        # step's positions (idle slots can run past max_len: clamped)
        rc = self._rope_rows(next(iter(cache.values())).length[0][:, None])
        return TF.decode_step(params, cache, tokens, self.cfg, self.policy,
                              self.parallel, rope_cache=rc)

    def _paged_prefill(self, params, cache, tables, tokens, pref_lens, prompt_lens,
                       admit, last_only):
        tokens = self._tensor(tokens, torch.long)
        pref = self._tensor(pref_lens, torch.int32)
        # suffix tokens sit at absolute positions pref + [0, S)
        pos = pref.long()[:, None] + torch.arange(tokens.shape[1], device=self.device)
        return TF.paged_prefill(params, cache, self._tensor(tables, torch.int32), tokens,
                                pref, self._tensor(prompt_lens, torch.int32),
                                self._tensor(admit, torch.bool), self.cfg, self.policy,
                                self.parallel, last_only=last_only,
                                rope_cache=self._rope_rows(pos))

    @torch.inference_mode()
    def prefill_paged(self, params, cache, tables, tokens, pref_lens, prompt_lens, admit):
        """Paged prefill: seed admitted slots' block tables from prompt
        *suffixes*. tokens: (max_batch, S) right-padded suffix tokens;
        pref_lens: (max_batch,) resident prefix lengths (adopted blocks or
        the chunk cursor); prompt_lens: prefill targets; tables: (max_batch,
        blocks_per_slot) int32. Returns ``(logits (B, 1, V), cache)`` — each
        slot's last valid position."""
        return self._paged_prefill(params, cache, tables, tokens, pref_lens, prompt_lens,
                                   admit, last_only=True)

    @torch.inference_mode()
    def decode_paged(self, params, cache, tables, tokens):
        """One paged decode step: tokens (max_batch, 1) appended through the
        block table. Same lockstep-length semantics as :meth:`decode`."""
        rc = self._rope_rows(next(iter(cache.values())).length[0][:, None])
        return TF.paged_decode_step(params, cache, self._tensor(tables, torch.int32),
                                    self._tensor(tokens, torch.long), self.cfg,
                                    self.policy, self.parallel, rope_cache=rc)

    @torch.inference_mode()
    def verify_paged(self, params, cache, tables, tokens, pref_lens, prompt_lens, admit):
        """Speculative verify: score ``tokens`` (max_batch, spec_k + 1) — per
        slot ``[current, draft_1..draft_k]`` right-padded — at absolute
        positions ``pref_lens + [0, spec_k]`` through the paged prefill path
        (commit-then-attend: draft K/V are written optimistically, an
        accepted prefix keeps them). Returns ``(argmax (B, spec_k + 1)
        numpy int, cache)``: the model's greedy token at every verified
        position."""
        logits, cache = self._paged_prefill(params, cache, tables, tokens, pref_lens,
                                            prompt_lens, admit, last_only=False)
        return torch.argmax(logits, dim=-1).cpu().numpy(), cache

    @torch.inference_mode()
    def set_lengths(self, cache, lens):
        """Overwrite the paged cache's per-slot lengths with host truth
        (``lens`` (max_batch,)): the lazy re-sync after a speculative
        rejection left the device lengths over-counting."""
        return TF.set_serve_lengths(cache, self._tensor(lens, torch.int32))

    def sample(self, logits, uids, steps, seed: Optional[int] = None) -> np.ndarray:
        """Next tokens (B,) as numpy from last-position logits (B, V) with
        the engine's temperature (0 = greedy argmax). ``uids``/``steps``
        (B,) make temperature > 0 draws a function of (seed, request uid,
        generation step); ``seed`` defaults to ``ServeConfig.seed``."""
        seed = self.serve_cfg.seed if seed is None else seed
        return self._sample(logits, seed, uids, steps).cpu().numpy()

    # -- the serving loop ---------------------------------------------------
    def _stats_registry(self) -> MetricsRegistry:
        """The stats-row schema of the JAX engine, declared once; the empty
        and the measured path snapshot this same registry."""
        scfg = self.serve_cfg
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
        for k in SlotScheduler(scfg.max_batch, scfg.max_len).counters:
            reg.counter(f"sched_{k}")
        if scfg.cache_mode == "paged":
            for k in ("prefix_lookups", "prefix_hits", "prefill_tokens_saved",
                      "peak_blocks_in_use", "peak_live_blocks", "peak_cache_bytes"):
                reg.counter(k)
            reg.gauge("prefix_hit_rate")
            reg.counter("num_blocks").set(self.num_blocks)
            reg.counter("block_bytes").set(self.block_bytes)
            reg.counter("ring_equiv_cache_bytes").set(self.ring_equiv_cache_bytes)
            # drafts proposed / accepted (the bonus token of a verify is
            # not counted as accepted) and verify calls
            for k in ("spec_drafted", "spec_accepted", "spec_verify_calls"):
                reg.counter(k)
            reg.gauge("spec_acceptance_rate")
        for k in SUPERVISOR_KEYS:
            reg.counter(f"supervisor_{k}")
        return reg

    def _fill_supervisor(self, reg: MetricsRegistry) -> None:
        """Copy the attached stability source's supervisor counters into
        the registry (a TrainSupervisor, anything with a
        ``report()``/``stability_report()``, or a plain dict)."""
        src = self.stability_source
        if src is None:
            return
        if isinstance(src, dict):
            rep = src
        elif hasattr(src, "report"):
            rep = src.report()
        elif hasattr(src, "stability_report"):
            rep = src.stability_report().get("supervisor", {})
        else:
            raise TypeError(f"stability_source {type(src).__name__} has "
                            "no report()/stability_report()")
        for k in SUPERVISOR_KEYS:
            if k in rep:
                reg.counter(f"supervisor_{k}").set(rep[k])

    def _empty_stats(self) -> Dict[str, float]:
        reg = self._stats_registry()
        self._fill_supervisor(reg)
        return reg.snapshot()

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
        prefill over every prefilling slot, decode one token for the whole
        batch, record and evict finished sequences. Returns
        ``(generations, stats)`` with the JAX engine's stats keys:
        tokens/s, TTFT, decode-only and wall inter-token latency, prefill
        stall, scheduler counters and, paged, the pool, prefix-cache and
        speculative counters.

        Under ``cache_mode="paged"`` the loop also drives a
        :class:`~repro_torch.serve.paged.PagedCacheManager`: admission runs
        the radix prefix-cache lookup and allocates block tables (the
        scheduler's ``fits`` hook lets a small request pass a pending one
        whose blocks cannot be met yet), decode grows tables a block at a
        time, and completion parks full blocks in the prefix cache. With
        ``prefill_chunk_tokens > 0`` each step carries a fixed token budget
        (live decode tokens first, the rest split across prefills, the
        request's ``prefilled`` cursor advancing across steps); with
        ``preemption="recompute"`` an empty pool preempts the newest
        occupied request to the queue. With ``spec_mode="ngram"`` (greedy
        only) a wave where some slot has drafts runs one verify call
        instead of the plain decode, and records up to ``spec_k + 1``
        tokens per slot.
        """
        scfg = self.serve_cfg
        B = scfg.max_batch
        paged = scfg.cache_mode == "paged"
        preempt_on = paged and scfg.preemption == "recompute"
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
            return [[] for _ in prompts], self._empty_stats()
        tele = as_telemetry(self.telemetry)
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
                if tele.enabled:
                    tele.emit("request", uid=uids[i], event="submitted",
                              prompt_len=len(p), budget=budgets[i])
        # speculative decoding is greedy-only: acceptance compares drafts
        # against argmax
        spec_on = paged and scfg.spec_mode == "ngram" and scfg.temperature == 0
        proposer = (NgramProposer(scfg.spec_k, scfg.spec_ngram, scfg.spec_min_ngram)
                    if spec_on else None)
        mgr = fits = None
        if paged:
            mgr = PagedCacheManager(self.num_blocks, scfg.block_size, B,
                                    self.blocks_per_slot, prefix_cache=scfg.prefix_cache,
                                    preemption=preempt_on)
            # a preempted request re-prefills prompt + generated-so-far with
            # only its remaining budget left to claim
            fits = lambda r: mgr.fits(len(r.context), r.remaining_new,  # noqa: E731
                                      prompt=r.context)
        cache = self.init_cache()
        cur = np.zeros((B,), np.int64)          # next input token per slot
        n_new = n_prefill_tok = n_steps = n_prefills = n_chunks = 0
        n_decoded = n_slot_passes = 0
        spec_drafted = spec_accepted = n_verify = 0
        len_dirty = False       # device lengths over-count after a partial
        # spec rejection; re-synced lazily before the next plain decode
        prefill_s = decode_s = 0.0
        ttft: Dict[int, float] = {}
        stall: Dict[int, float] = {}
        last_t: Dict[int, float] = {}
        peak_live_blocks = 0
        wave = 0                              # engine-step index (events)

        def _finish(slot, r):
            last_t.pop(slot, None)
            stall.pop(slot, None)
            if tele.enabled:
                tele.emit("request", uid=r.uid, event="finished",
                          reason=r.finish_reason, n_generated=len(r.generated),
                          wave=wave)
            if paged:
                # K/V written: the context and every decoded token but the
                # last (never consumed); full blocks park for reuse
                mgr.release(slot, r.context[:-1])

        def _preempt(vslot, vr, prefilling_set):
            """Park ``vslot``'s blocks to the radix cache and requeue."""
            written = (vr.context[:vr.prefilled]
                       if vslot in prefilling_set else vr.context[:-1])
            mgr.release(vslot, written)
            sched.preempt(vslot)
            last_t.pop(vslot, None)
            stall.pop(vslot, None)
            if tele.enabled:
                tele.emit("request", uid=vr.uid, event="preempted", slot=vslot,
                          n_generated=len(vr.generated), wave=wave)

        self._sync()
        t0 = time.perf_counter()
        while sched.has_work:
            tele.maybe_profile(wave)
            if paged:
                mgr.begin_wave()
            admits = sched.admit(fits=fits)
            for slot, r in admits:
                # resident tokens: adopted prefix blocks (paged); the chunk
                # loop below prefills context[prefilled:] from here
                r.prefilled = (mgr.admit(slot, r.context, r.remaining_new)
                               if paged else 0)
                if tele.enabled:
                    ev = dict(uid=r.uid, event="admitted", slot=slot, wave=wave,
                              queue_depth=sched.pending)
                    if paged:       # radix adoption + pool pressure
                        ev.update(prefix_adopted=r.prefilled, live_blocks=mgr.live_blocks)
                    tele.emit("request", **ev)
            if paged and admits:
                peak_live_blocks = max(peak_live_blocks, mgr.live_blocks)
            prefilling = sched.prefilling
            if prefilling:
                t_pf = time.perf_counter()
                decoding = [s for s, _ in sched.running]
                if paged and scfg.prefill_chunk_tokens:
                    # fixed per-step token budget: live decode tokens first,
                    # the rest split across prefills
                    budget = max(scfg.prefill_chunk_tokens - len(decoding), 1)
                    slice_ = max(budget // len(prefilling), 1)
                else:
                    slice_ = scfg.max_len          # monolithic prefill
                chunks = {s: min(len(r.context) - r.prefilled, slice_)
                          for s, r in prefilling}
                # the bucket may round past a non-pow2 max_len; the
                # scheduler guarantees every prompt fits the cache
                S = min(prefill_bucket(max(chunks.values()),
                                       scfg.prefill_bucket), scfg.max_len)
                toks = np.zeros((B, S), np.int64)
                toks_l = np.ones((B,), np.int32)   # dummy 1 for idle slots
                pref_l = np.zeros((B,), np.int32)
                mask = np.zeros((B,), bool)
                uids_a = np.zeros((B,), np.int64)
                steps_a = np.zeros((B,), np.int64)
                for slot, r in prefilling:
                    c = chunks[slot]
                    toks[slot, :c] = r.context[r.prefilled:r.prefilled + c]
                    toks_l[slot] = r.prefilled + c
                    pref_l[slot] = r.prefilled
                    mask[slot] = True
                    uids_a[slot] = r.uid
                    steps_a[slot] = len(r.generated)
                if paged:
                    logits, cache = self.prefill_paged(params, cache, mgr.tables, toks,
                                                       pref_l, toks_l, mask)
                else:
                    logits, cache = self.prefill(params, cache, toks, toks_l, mask)
                # sample here too: a max_new_tokens=1 run finishes at prefill
                tok = self.sample(logits[:, 0], uids_a, steps_a, seed)
                now = time.perf_counter()
                dur = now - t_pf
                for slot, r in prefilling:
                    r.prefilled += chunks[slot]
                    if tele.enabled:
                        tele.emit("request", uid=r.uid, event="prefill_chunk", slot=slot,
                                  tokens=chunks[slot], prefilled=r.prefilled,
                                  context_len=len(r.context), wave=wave)
                    if r.prefilled >= len(r.context):
                        # prompt resident: first token from the last position
                        done = sched.record(slot, tok[slot])
                        cur[slot] = tok[slot]
                        if r.uid not in ttft:
                            ttft[r.uid] = now - t0
                            tele.emit("request", uid=r.uid, event="first_token",
                                      ttft_s=ttft[r.uid], wave=wave)
                        last_t[slot] = now
                        n_new += 1
                        if done:
                            _finish(slot, r)
                for slot in decoding:
                    # the prefill sat between two of this slot's tokens
                    stall[slot] = stall.get(slot, 0.0) + dur
                n_prefill_tok += int(sum(chunks.values()))
                n_chunks += len(prefilling)
                n_prefills += 1
                prefill_s += dur
                if tele.enabled:
                    tele.emit_span("prefill_wave", time.time() - dur, dur, wave=wave,
                                   slots=len(prefilling),
                                   tokens=int(sum(chunks.values())), bucket=S)
                    tele.emit("wave", wave=wave, mode="prefill", dur_s=dur,
                              slots=len(prefilling), tokens=int(sum(chunks.values())))
            running = sched.running
            if not running:
                wave += 1
                continue
            drafts: Dict[int, List[int]] = {}
            if spec_on:
                for slot, r in running:
                    # clamp so optimistic draft K/V stay inside the slot's
                    # worst-case block reservation (remaining_new - 1
                    # drafts) and inside the table and RoPE range (max_len)
                    cap = min(scfg.spec_k, r.remaining_new - 1,
                              scfg.max_len - r.total_len)
                    if cap >= 1:
                        d = proposer.propose(r.context, cap)
                        if d:
                            drafts[slot] = d
            dead: set = set()                 # slots preempted this step
            if paged:
                pf_set = {s for s, _ in sched.prefilling}
                for slot, r in running:
                    # K/V writes this step: position total_len - 1 (the token
                    # consumed) through total_len - 1 + k (the last draft)
                    last = r.total_len - 1 + len(drafts.get(slot, ()))
                    while slot not in dead:
                        try:
                            for wp in range(r.total_len - 1, last + 1):
                                mgr.ensure_block(slot, wp)
                            break
                        except NoFreeBlocks:
                            if not preempt_on:
                                raise
                            # preempt-to-queue: park the newest occupied
                            # request's blocks (evictable, so the retry's
                            # alloc reclaims them) and requeue it
                            cands = [sq for sq in sched.occupied if sq[0] not in dead]
                            vslot, vr = max(cands, key=lambda sq: sq[1].uid)
                            _preempt(vslot, vr, pf_set)
                            dead.add(vslot)
                peak_live_blocks = max(peak_live_blocks, mgr.live_blocks)
            drafts = {s: d for s, d in drafts.items() if s not in dead}
            t_dec = time.perf_counter()
            if drafts:
                # -- speculative wave: one k-query verify call --------------
                S_v = scfg.spec_k + 1         # one shape for every verify
                toks = np.zeros((B, S_v), np.int64)
                pref = np.zeros((B,), np.int32)
                lens = np.ones((B,), np.int32)
                mask = np.zeros((B,), bool)
                for slot, r in running:
                    if slot in dead:
                        continue
                    d = drafts.get(slot, ())
                    L = r.total_len - 1       # K/V-resident tokens
                    toks[slot, 0] = cur[slot]
                    toks[slot, 1:1 + len(d)] = d
                    pref[slot] = L
                    lens[slot] = L + 1 + len(d)
                    mask[slot] = True
                arg, cache = self.verify_paged(params, cache, mgr.tables, toks, pref,
                                               lens, mask)
                now = time.perf_counter()
                for slot, r in running:
                    if slot in dead:
                        continue
                    d = drafts.get(slot, ())
                    n_in = 1 + len(d)
                    a = 0                     # accepted draft prefix
                    while a < len(d) and d[a] == int(arg[slot, a]):
                        a += 1
                    # the a verified drafts plus the bonus token at the first
                    # mismatch: what a + 1 greedy decode steps would give
                    delta = now - last_t[slot]
                    stalled = stall.pop(slot, 0.0)
                    done, m = False, 0
                    for j in range(a + 1):
                        t = int(arg[slot, j])
                        done = sched.record(slot, t)
                        cur[slot] = t
                        m += 1
                        # the m tokens land together: the wave's wall gap
                        # belongs to the first, the rest are free
                        h_itl_wall.observe(delta if j == 0 else 0.0)
                        h_itl.observe(max(delta - stalled, 0.0) if j == 0 else 0.0)
                        if done:
                            break
                    if stalled:
                        h_stall.observe(stalled)
                    last_t[slot] = now
                    spec_drafted += len(d)
                    spec_accepted += min(a, m)
                    n_new += m
                    n_decoded += m
                    n_slot_passes += 1
                    if done:
                        _finish(slot, r)      # release frees the dead tail
                    else:
                        # rejection: free whole blocks past the kept tokens;
                        # stale cells in kept blocks are masked by kv_len
                        # until overwritten
                        mgr.rollback(slot, r.total_len - 1)
                        if m != n_in:
                            len_dirty = True
                n_steps += 1
                n_verify += 1
                if tele.enabled:
                    v_dur = now - t_dec
                    tele.emit_span("verify_wave", time.time() - v_dur, v_dur, wave=wave)
                    tele.emit("wave", wave=wave, mode="verify", dur_s=v_dur,
                              drafted=sum(len(d) for d in drafts.values()),
                              slots=len(drafts))
            else:
                # -- plain wave: ordinary one-token decode ------------------
                if paged and len_dirty:
                    # the only step that reads the device lengths: restore
                    # host truth (prefilling slots keep their chunk cursor,
                    # idle slots write to the trash block anyway)
                    lens = np.zeros((B,), np.int32)
                    pf_now = {s for s, _ in sched.prefilling}
                    for slot, r in sched.occupied:
                        lens[slot] = r.prefilled if slot in pf_now else r.total_len - 1
                    cache = self.set_lengths(cache, lens)
                    len_dirty = False
                if paged:
                    logits, cache = self.decode_paged(params, cache, mgr.tables,
                                                      cur[:, None])
                else:
                    logits, cache = self.decode(params, cache, cur[:, None])
                uids_a = np.zeros((B,), np.int64)
                steps_a = np.zeros((B,), np.int64)
                for slot, r in running:
                    if slot not in dead:
                        uids_a[slot] = r.uid
                        steps_a[slot] = len(r.generated)
                tok = self.sample(logits[:, 0], uids_a, steps_a, seed)
                now = time.perf_counter()
                n_live = 0
                for slot, r in running:
                    if slot in dead:          # preempted mid-step: its table
                        continue              # row decoded into the trash block
                    done = sched.record(slot, tok[slot])
                    cur[slot] = tok[slot]
                    delta = now - last_t[slot]
                    stalled = stall.pop(slot, 0.0)
                    h_itl_wall.observe(delta)
                    h_itl.observe(max(delta - stalled, 0.0))
                    if stalled:
                        h_stall.observe(stalled)
                    last_t[slot] = now
                    n_live += 1
                    if done:
                        _finish(slot, r)
                n_new += n_live
                n_decoded += n_live
                n_slot_passes += n_live
                n_steps += 1
                if tele.enabled:
                    d_dur = now - t_dec
                    tele.emit_span("decode_wave", time.time() - d_dur, d_dur, wave=wave)
                    tele.emit("wave", wave=wave, mode="decode", dur_s=d_dur, slots=n_live)
            decode_s += now - t_dec
            wave += 1
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
        reg.gauge("tokens_per_model_pass").set(n_decoded / max(n_slot_passes, 1))
        reg.fill_counters(sched.counters, prefix="sched_")
        if paged:
            mstats = mgr.stats()
            reg.gauge("prefix_hit_rate").set(mstats.pop("prefix_hit_rate"))
            reg.fill_counters(mstats)
            reg.counter("peak_live_blocks").set(peak_live_blocks)
            reg.counter("peak_cache_bytes").set(mgr.peak_in_use * self.block_bytes)
            reg.counter("spec_drafted").set(spec_drafted)
            reg.counter("spec_accepted").set(spec_accepted)
            reg.counter("spec_verify_calls").set(n_verify)
            reg.gauge("spec_acceptance_rate").set(spec_accepted / max(spec_drafted, 1))
        self._fill_supervisor(reg)
        stats = reg.snapshot()
        # itl is wall-minus-stall per sample; the bucketed estimator can
        # invert the order by one bucket width, so pin it at the row level
        for p in (50, 95):
            stats[f"itl_p{p}_s"] = min(stats[f"itl_p{p}_s"],
                                       stats[f"itl_wall_p{p}_s"])
        if tele.enabled:
            tele.emit("serve_stats", **stats)
        if tele._profiling:        # window ran off the end of the run
            tele._stop_profile(wave)
        return [[] if u is None else sched.results[u] for u in uids], stats


def _check_serve_config(scfg: ServeConfig):
    """The JAX package's ``make_serve_engine`` validation, with its
    exception types: ValueError for a value outside a field's choices,
    NotImplementedError for a combination neither engine serves."""
    paged = scfg.cache_mode == "paged"
    if scfg.cache_mode not in ("ring", "paged"):
        raise ValueError(f"cache_mode {scfg.cache_mode!r} not in ('ring', 'paged')")
    if scfg.preemption not in ("off", "recompute"):
        raise ValueError(f"preemption {scfg.preemption!r} not in ('off', 'recompute')")
    if not paged and (scfg.prefill_chunk_tokens or scfg.preemption != "off"):
        raise NotImplementedError(
            "prefill_chunk_tokens / preemption are paged-cache features: the ring "
            "cache has no block table to chunk against or park into; set "
            "cache_mode='paged'")
    if scfg.spec_mode not in ("off", "ngram"):
        raise ValueError(f"spec_mode {scfg.spec_mode!r} not in ('off', 'ngram')")
    if scfg.spec_mode == "ngram":
        if not paged:
            raise NotImplementedError(
                "spec_mode='ngram' verifies drafts through the paged block-table "
                "prefill path and rolls rejected K/V back by truncating the block "
                "table; the ring cache has neither — set cache_mode='paged'")
        if scfg.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {scfg.spec_k}")
        if not 1 <= scfg.spec_min_ngram <= scfg.spec_ngram:
            raise ValueError(f"need 1 <= spec_min_ngram <= spec_ngram, got "
                             f"{scfg.spec_min_ngram}..{scfg.spec_ngram}")
    if paged and scfg.rollover:
        raise NotImplementedError(
            "cache_mode='paged' has no rollover: the block table is append-only; "
            "use the ring cache for sliding-window decode")


def make_serve_engine(model, serve_cfg: ServeConfig, *,
                      parallel: Optional[ParallelConfig] = None,
                      policy: Optional[QuantPolicy] = None,
                      device="cuda") -> ServeEngine:
    """Assemble the serving stack for ``model`` on ``device``.

    ``model`` is an arch name, a ModelConfig or a ModelBundle (dense and
    mixture-of-experts decoder-only LMs; SSM and hybrid stacks, a
    frontend, enc-dec and CLIP raise the JAX engine's
    ``NotImplementedError`` as its subclass
    ``models.transformer.NoEnginePath``, and the serve CLI falls back to
    ``decode_step_fallback``, as the JAX CLI does). ``device`` defaults to the card;
    on a host without one this raises unless ``device="cpu"`` is asked for.
    ``policy`` defaults to ``QuantPolicy(serve_cfg.quant_mode)``, as the JAX
    engine builds it: bf16 compute in every mode, so ``fp16`` serves the
    ``bf16`` computation bit for bit and ``fp32`` runs each linear in f32 on
    the bf16-rounded weights (q, k and v in f32 over the bf16 cache, which
    the decode and paged kernels take). An explicit policy whose compute
    dtype is f16 raises: its decode kernels are ROADMAP.md Queue 1 #14.

    ``parallel`` defaults to ``ParallelConfig(remat="none")``, whose
    ``attn_impl="flash_scan"`` runs the flash-attention kernels (ring) or
    the paged-attention kernels (``cache_mode="paged"``), as the JAX
    engine's default does on its Pallas backends. The TPU kernels' tile
    sizes (``attn_block_q``/``attn_block_k``) raise: the card's kernels
    choose their own. The serve config is validated as the JAX package
    validates it, with the same exception types.
    """
    from repro_torch.models import build
    if isinstance(model, str):
        from repro_torch.configs import get_config
        model = get_config(model)
    bundle = model if hasattr(model, "param_specs") else build(model)
    if getattr(bundle.cfg, "family", "") in ("clip", "encdec"):
        raise TF.NoEnginePath(
            "ServeEngine serves decoder-only LMs; CLIP scores pairs via "
            "models/clip.py and enc-dec decodes via models/encdec.py")
    TF._require_all_attention(bundle.cfg, "make_serve_engine")
    parallel = parallel or ParallelConfig(remat="none")
    flash_tiles = ("the TPU flash kernels' tile sizes: the card's flash kernels "
                   "choose their own tiles")
    _only_defaults(parallel, ("attn_block_q", "attn_block_k"), flash_tiles)
    _only_defaults(serve_cfg, ("attn_block_q", "attn_block_k"), flash_tiles)
    if parallel.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {parallel.attn_impl!r} not in {ATTN_IMPLS}")
    _check_serve_config(serve_cfg)
    policy = policy or QuantPolicy(serve_cfg.quant_mode)
    if policy.compute_dtype == torch.float16:
        raise NotImplementedError(
            "serving with an f16 compute dtype (an explicit FP16 policy) needs f16 forms "
            "of decode_fwd and the paged kernels: ROADMAP.md Queue 1 #14")
    return ServeEngine(bundle, serve_cfg, parallel, policy, device)
