"""Slot scheduler for continuous batching: FIFO admission, per-slot
eviction, bounded by a fixed (max_batch, max_len) decode batch.

A copy of the JAX package's ``repro/serve/scheduler.py`` (pure Python;
the port imports nothing of ``repro``).

The scheduler is deliberately pure Python with no tensor dependency — it
owns *which request lives in which batch slot*; all tensor work (cache
writes, masking) keys off the per-slot lengths the engine derives from
it. Requests are admitted in arrival order into the lowest free slot and
evicted the moment they finish (max_new_tokens reached, EOS sampled, or
the ring cache full when ``rollover`` is off), so a freed slot is
reusable on the very next engine iteration.

>>> s = SlotScheduler(max_batch=2, max_len=16)
>>> s.submit([1, 2, 3], max_new_tokens=2)
0
>>> s.submit([4, 5], max_new_tokens=2)
1
>>> s.submit([6], max_new_tokens=1)
2
>>> [(slot, r.uid) for slot, r in s.admit()]   # FIFO into free slots
[(0, 0), (1, 1)]
>>> s.admit()                                  # batch full: uid 2 waits
[]
>>> s.pending
1
>>> s.record(0, 7)                             # first sampled token
False
>>> s.record(0, 8)                             # hits max_new_tokens=2
True
>>> [(slot, r.uid) for slot, r in s.admit()]   # freed slot 0 reused
[(0, 2)]
>>> s.results[0]
[7, 8]
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def normalize_stop(stop) -> List[List[int]]:
    """Normalize one request's stop spec into a list of stop sequences.

    Accepts ``None`` (no stop sequences), one flat token-id sequence, or
    a sequence of sequences. Matching is host-side and exact: a request
    finishes when its ``generated`` tail equals any stop sequence
    (the stop tokens are kept in the output, like EOS).

    >>> normalize_stop(None)
    []
    >>> normalize_stop([5, 6])
    [[5, 6]]
    >>> normalize_stop([[5], [6, 7]])
    [[5], [6, 7]]
    >>> normalize_stop([])
    []
    >>> normalize_stop([[]])
    Traceback (most recent call last):
        ...
    ValueError: empty stop sequence
    """
    if stop is None:
        return []
    stop = list(stop)
    if not stop:
        return []
    if not isinstance(stop[0], (list, tuple)):
        stop = [stop]
    out = []
    for s in stop:
        s = [int(t) for t in s]
        if not s:
            raise ValueError("empty stop sequence")
        out.append(s)
    return out


@dataclasses.dataclass
class Request:
    """One generation request tracked by the scheduler.

    ``prompt`` is the token ids to prefill; ``generated`` accumulates the
    sampled continuation. A request is finished when ``generated`` reaches
    ``max_new_tokens``, when ``eos_id`` is sampled, or when prompt +
    generated hits the cache capacity (unless the scheduler rolls over).

    ``prefilled`` is the chunked-prefill progress cursor: tokens of
    ``context`` whose KV is already resident (adopted prefix blocks plus
    committed chunks). The engine advances it one chunk per wave; a
    request is still *prefilling* until it reaches ``len(context)`` and
    the first sampled token is recorded. A preempted request re-enters
    the queue with the cursor reset — its ``context`` (prompt plus
    everything generated so far) is re-prefilled on the next admission,
    which is what makes preempt-by-recompute exact.
    """
    uid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    stop: List[List[int]] = dataclasses.field(default_factory=list)
    generated: List[int] = dataclasses.field(default_factory=list)
    prefilled: int = 0
    # why the request finished (an evicted_* counter name), for the
    # per-request telemetry "finished" event; repr=False keeps the
    # doctests' Request reprs stable
    finish_reason: Optional[str] = dataclasses.field(
        default=None, repr=False)

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def context(self) -> List[int]:
        """Tokens that must be KV-resident before the next decode — the
        effective prompt on (re)admission: the original prompt plus the
        continuation generated before any preemption."""
        return self.prompt + self.generated

    @property
    def remaining_new(self) -> int:
        """Token budget still unspent (= ``max_new_tokens`` until the
        request is preempted mid-generation)."""
        return self.max_new_tokens - len(self.generated)


class SlotScheduler:
    """Admit/evict requests into a fixed pool of decode-batch slots.

    >>> s = SlotScheduler(max_batch=1, max_len=4)
    >>> _ = s.submit([1, 2, 3], max_new_tokens=99)
    >>> [(slot, r.uid) for slot, r in s.admit()]
    [(0, 0)]
    >>> s.record(0, 9)      # cells used: prompt(3) + 0 — one more fits
    False
    >>> s.record(0, 9)      # prompt(3) + generated(2) > max_len: evicted
    True
    >>> s.has_work
    False
    """

    def __init__(self, max_batch: int, max_len: int, *,
                 rollover: bool = False):
        assert max_batch >= 1 and max_len >= 2
        self.max_batch = max_batch
        self.max_len = max_len
        self.rollover = rollover
        self._queue: deque[Request] = deque()
        self._slots: List[Optional[Request]] = [None] * max_batch
        self._prefilling: set[int] = set()   # slots mid-chunked-prefill
        self._next_uid = 0
        self.results: Dict[int, List[int]] = {}
        # observability: admission/eviction/queue counters, read via
        # ``counters`` (the engine folds them into generate()'s stats row)
        self.counters: Dict[str, int] = {
            "admitted": 0, "skipped": 0, "evicted_budget": 0,
            "evicted_eos": 0, "evicted_stop": 0, "evicted_cache": 0,
            "preempted": 0, "peak_queue_depth": 0}

    # -- submission / admission --------------------------------------------
    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 32,
               eos_id: Optional[int] = None, stop=None) -> int:
        """Queue a request; returns its uid. Prompts must fit the cache.

        ``max_new_tokens`` and ``stop`` are per-request: workloads can
        mix budgets and stop sequences in one batch (``stop`` takes
        anything :func:`normalize_stop` accepts).
        """
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.max_len:
            raise ValueError(f"prompt len {len(prompt)} > max_len "
                             f"{self.max_len}; truncate client-side")
        req = Request(self._next_uid, prompt, max_new_tokens, eos_id,
                      normalize_stop(stop))
        self._next_uid += 1
        self._queue.append(req)
        self.counters["peak_queue_depth"] = max(
            self.counters["peak_queue_depth"], len(self._queue))
        return req.uid

    def admit(self, fits: Optional[Callable[[Request], bool]] = None
              ) -> List[Tuple[int, Request]]:
        """Move queued requests into free slots, lowest slot first.
        Returns the (slot, request) pairs admitted this call — the engine
        prefills exactly these.

        Without ``fits`` admission is strict FIFO. With ``fits`` (the
        paged engine's block-budget check) a pending request whose demand
        can't currently be met no longer blocks the line: the scheduler
        *skips ahead* to the first queued request that fits, so a small
        request behind a too-big one still gets the free slot. Skipped
        requests keep their queue position (and FIFO priority) for the
        next admission wave. ``fits`` is consulted once per candidate and
        a True return admits immediately — stateful callbacks (block
        reservations) can count on it.

        Admitted slots enter the *prefilling* state (cleared by the first
        :meth:`record`): the engine runs their prompt — whole, or in
        ``prefill_chunk_tokens`` slices across waves — before they join
        the decode batch (``running``).

        >>> s = SlotScheduler(max_batch=1, max_len=64)
        >>> big = s.submit([1] * 40); small = s.submit([2, 3])
        >>> s.admit(fits=lambda r: len(r.prompt) <= 8)  # big can't fit...
        [(0, Request(uid=1, prompt=[2, 3], max_new_tokens=32, eos_id=None, stop=[], generated=[], prefilled=0))]
        >>> s.pending, s.counters["skipped"]    # ...small admitted past it
        (1, 1)
        """
        out = []
        charged = set()              # uids counted as skipped this call —
        # each slot rescans from the queue head, so a stuck request must
        # not inflate the counter once per free slot in the same wave
        for slot in range(self.max_batch):
            if self._slots[slot] is not None or not self._queue:
                continue
            pick = None
            for i, req in enumerate(self._queue):
                if fits is None or fits(req):
                    pick = i
                    break
            if pick is None:         # nothing in the queue fits right now
                break
            for passed in list(self._queue)[:pick]:
                if passed.uid not in charged:
                    charged.add(passed.uid)
                    self.counters["skipped"] += 1
            req = self._queue[pick]
            del self._queue[pick]
            self._slots[slot] = req
            self._prefilling.add(slot)
            self.counters["admitted"] += 1
            out.append((slot, req))
        return out

    # -- decode-step bookkeeping -------------------------------------------
    def record(self, slot: int, token: int) -> bool:
        """Record one sampled token for ``slot``; evicts and returns True
        when the request finished with it."""
        req = self._slots[slot]
        assert req is not None, f"slot {slot} is empty"
        self._prefilling.discard(slot)    # first token => prefill complete
        req.generated.append(int(token))
        # cache edge: after k generated tokens the ring holds prompt+k-1
        # KVs (the newest token's KV is only written when the next decode
        # consumes it), so another token fits until total_len exceeds
        # max_len — evicting at >= would short every near-full request.
        if len(req.generated) >= req.max_new_tokens:
            done, reason = True, "evicted_budget"
        elif req.eos_id is not None and int(token) == req.eos_id:
            done, reason = True, "evicted_eos"
        elif req.stop and any(req.generated[-len(s):] == s for s in req.stop):
            done, reason = True, "evicted_stop"
        elif not self.rollover and req.total_len > self.max_len:
            done, reason = True, "evicted_cache"
        else:
            done = False
        if done:
            self.counters[reason] += 1
            req.finish_reason = reason
            self.results[req.uid] = req.generated
            self._slots[slot] = None
        return done

    # -- preemption ----------------------------------------------------------
    def preempt(self, slot: int) -> Request:
        """Evict ``slot``'s request back to the queue (preempt-to-queue).

        The request keeps everything generated so far; its prefill cursor
        resets, so re-admission re-prefills ``context`` (prompt plus
        continuation — with a prefix cache, adoption of the parked blocks
        makes that nearly free). It re-enters the queue at its FIFO
        arrival position (before any later-submitted request), so repeated
        preemption cannot starve it behind fresh traffic.

        >>> s = SlotScheduler(max_batch=1, max_len=16)
        >>> a = s.submit([1, 2]); b = s.submit([3])
        >>> _ = s.admit(); s.record(0, 7)
        False
        >>> s.preempt(0).uid                  # uid 0 back to the queue...
        0
        >>> back = s.admit()                  # ...ahead of uid 1
        >>> [(sl, r.uid) for sl, r in back]
        [(0, 0)]
        >>> back[0][1].generated              # continuation survives
        [7]
        """
        req = self._slots[slot]
        assert req is not None, f"slot {slot} is empty"
        self._slots[slot] = None
        self._prefilling.discard(slot)
        req.prefilled = 0
        idx = next((i for i, q in enumerate(self._queue) if q.uid > req.uid),
                   len(self._queue))
        self._queue.insert(idx, req)
        self.counters["preempted"] += 1
        self.counters["peak_queue_depth"] = max(
            self.counters["peak_queue_depth"], len(self._queue))
        return req

    # -- introspection ------------------------------------------------------
    @property
    def running(self) -> List[Tuple[int, Request]]:
        """Slots in the *decode* batch — occupied and past prefill. The
        engine decodes exactly these; chunk-prefilling slots are listed
        by :attr:`prefilling` instead."""
        return [(i, r) for i, r in enumerate(self._slots)
                if r is not None and i not in self._prefilling]

    @property
    def prefilling(self) -> List[Tuple[int, Request]]:
        """Slots still working through their prompt (progress cursor in
        ``Request.prefilled``) — one chunk per engine wave."""
        return [(i, r) for i, r in enumerate(self._slots)
                if r is not None and i in self._prefilling]

    @property
    def occupied(self) -> List[Tuple[int, Request]]:
        """Every occupied slot, decoding or prefilling — the preemption
        victim candidates."""
        return [(i, r) for i, r in enumerate(self._slots) if r is not None]

    @property
    def pending(self) -> int:
        """Current queue depth (requests submitted, not yet admitted)."""
        return len(self._queue)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(r is not None for r in self._slots)
