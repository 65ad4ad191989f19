"""Block pool: ref-counted physical KV blocks + per-slot block tables.

A copy of the JAX package's ``repro/serve/paged/block_pool.py``, with one
repair: :meth:`PagedCacheManager.fits` also discounts, from the evictable
blocks, the parked blocks that earlier promises of the same admission
wave will pin by adopting them (the reference counts each promise's own
hits only, so two admissions in one wave could both count the same
evictable blocks and ``admit`` then found the pool empty; ROADMAP Queue 3).

Pure-Python host-side bookkeeping (no tensor dependency — the same
discipline as ``serve/scheduler.py``): the *device* side is a fixed pool
of ``(num_blocks + 1, block_size, KV, hd)`` K/V blocks per layer (the
last block is the shared **trash block** that absorbs writes from idle
slots and masked pad positions); this module decides which physical
block holds which request's logical block.

Two layers:

* :class:`BlockPool` — the allocator. Blocks are handed out with
  refcount 1, shared via :meth:`retain` (prefix-cache adoption), and
  returned to the free list when the count hits zero. Double-free and
  foreign-id release raise — the invariants the leak tests pin.
* :class:`PagedCacheManager` — the engine's view: owns the per-slot
  block-table array the model steps consume, admission accounting
  (block *reservations* so concurrent slots can't promise the same free
  blocks to two requests), on-demand decode growth, and release/park
  into the :class:`~repro_torch.serve.paged.prefix_cache.RadixPrefixCache`.

>>> pool = BlockPool(2)
>>> a = pool.alloc(); b = pool.alloc()
>>> pool.alloc()                    # doctest: +IGNORE_EXCEPTION_DETAIL
Traceback (most recent call last):
    ...
NoFreeBlocks: block pool exhausted (2 blocks)
>>> pool.retain(a)          # a second owner (e.g. the prefix cache)
>>> pool.release(a)         # first owner gone; block still live
>>> pool.free
0
>>> pool.release(a); pool.free      # last owner gone: block frees
1
>>> pool.release(a)                 # doctest: +IGNORE_EXCEPTION_DETAIL
Traceback (most recent call last):
    ...
ValueError: release of free block 0 (double free?)
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np


class NoFreeBlocks(RuntimeError):
    """The pool (including evictable prefix-cache blocks) is exhausted."""


class BlockPool:
    """Fixed pool of ``num_blocks`` physical block ids with refcounts.

    Observers can :meth:`subscribe` to refcount transitions — the radix
    prefix cache uses this to keep its evictable-block count incremental
    (adoption and release happen through the pool, outside the cache's
    own call surface)."""

    def __init__(self, num_blocks: int):
        assert num_blocks >= 1
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        self._watchers: List = []

    def subscribe(self, fn) -> None:
        """Register ``fn(bid, refcount)`` to run after every refcount
        change (alloc -> 1, retain -> +1, release -> -1 incl. 0)."""
        self._watchers.append(fn)

    def _notify(self, bid: int) -> None:
        rc = self._ref.get(bid, 0)
        for fn in self._watchers:
            fn(bid, rc)

    def alloc(self) -> int:
        """Pop a free block; the caller owns one reference."""
        if not self._free:
            raise NoFreeBlocks(f"block pool exhausted ({self.num_blocks} "
                               "blocks)")
        bid = self._free.pop()
        self._ref[bid] = 1
        self._notify(bid)
        return bid

    def retain(self, bid: int) -> None:
        """Add a reference to a live block (prefix sharing)."""
        if bid not in self._ref:
            raise ValueError(f"retain of free block {bid}")
        self._ref[bid] += 1
        self._notify(bid)

    def release(self, bid: int) -> None:
        """Drop one reference; the block frees when the count hits 0."""
        if bid not in self._ref:
            raise ValueError(f"release of free block {bid} (double free?)")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            del self._ref[bid]
            self._free.append(bid)
        self._notify(bid)

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_blocks - len(self._free)


class PagedCacheManager:
    """Engine-side paged-cache bookkeeping: tables, admission, growth.

    ``tables`` is the live ``(max_batch, blocks_per_slot)`` int32 array
    the prefill/decode steps read (rows of idle slots point every
    entry at the trash block ``num_blocks``). The manager guarantees, for
    every *live* slot, that a physical block exists for each logical
    block a write will touch — admission allocates the prompt's blocks
    (minus adopted shared prefix blocks), :meth:`ensure_block` grows one
    block at a time during decode, and a per-slot *reservation* keeps
    admission from promising blocks that running requests will still
    claim for their remaining token budget.

    >>> m = PagedCacheManager(num_blocks=8, block_size=4, max_batch=2,
    ...                       blocks_per_slot=4)
    >>> m.admit(0, [1, 2, 3, 4, 5], max_new_tokens=4)   # no cache yet
    0
    >>> int(m.tables[0, 0]) != m.trash, int(m.tables[0, 2]) == m.trash
    (True, True)
    >>> m.pool.in_use                                   # ceil(5/4) blocks
    2
    >>> m.fits(5, 40)   # budget past the cache edge truncates there, so
    ...                 # demand caps at blocks_per_slot — like ring mode
    True
    >>> m.begin_wave()
    >>> m.release(0, [1, 2, 3, 4, 5])                   # parks full block
    >>> m.admit(1, [1, 2, 3, 4, 9], max_new_tokens=4)   # adopts it: 4 hit
    4
    """

    def __init__(self, num_blocks: int, block_size: int, max_batch: int,
                 blocks_per_slot: int, *, prefix_cache: bool = True,
                 preemption: bool = False):
        from repro_torch.serve.paged.prefix_cache import RadixPrefixCache
        self.pool = BlockPool(num_blocks)
        self.block_size = block_size
        self.trash = num_blocks
        self.blocks_per_slot = blocks_per_slot
        self.preemption = preemption
        self.cache: Optional[RadixPrefixCache] = (
            RadixPrefixCache(self.pool, block_size) if prefix_cache else None)
        self.tables = np.full((max_batch, blocks_per_slot), self.trash,
                              np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(max_batch)]
        self._reserved: List[int] = [0] * max_batch
        self._wave_hold = 0          # blocks promised by fits() this wave
        self._wave_pins = 0          # parked blocks those promises will adopt
        # stats the engine folds into generate()'s row
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.peak_in_use = 0

    # -- sizing --------------------------------------------------------------
    def blocks_written(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case blocks a request touches: the prompt plus every
        generated token except the last (whose KV is never written),
        capped at the table width — the scheduler evicts at the
        ``max_len`` cache edge exactly like the ring path, so no request
        ever writes past ``blocks_per_slot`` blocks however large its
        token budget is."""
        need = math.ceil((prompt_len + max_new_tokens - 1) / self.block_size)
        return min(need, self.blocks_per_slot)

    def begin_wave(self) -> None:
        """Reset the per-wave admission hold. The engine calls this
        before each ``scheduler.admit(fits=...)`` so one wave's fits
        promises don't leak into the next (by admit time they've turned
        into real allocations + reservations)."""
        self._wave_hold = 0
        self._wave_pins = 0

    def fits(self, prompt_len: int, max_new_tokens: int,
             prompt: Optional[Sequence[int]] = None) -> bool:
        """Can a request be admitted *now* without over-promising blocks?

        Counts free + evictable blocks minus outstanding reservations
        *and* minus what earlier fits() calls in the same admission wave
        already promised (a True return admits — the scheduler contract —
        so the promise is recorded immediately, before the corresponding
        :meth:`admit` lands). Shared full prefix blocks the prompt would
        adopt (``prompt`` given) are credited against the demand — but
        also *discounted from the evictable pool*, since adoption pins
        them (an adopted parked block can no longer be evicted to feed
        this same request's fresh allocations).

        With ``preemption`` on, admission is *optimistic*: the demand is
        only the prompt's blocks (no worst-case generation reservation),
        so capacity parked for tokens that may never be generated is
        handed to the queue instead — the engine preempts-to-queue when
        decode growth later finds the pool genuinely empty. The loud
        worst-case check below still applies either way: a request the
        pool can *never* hold would otherwise preempt forever.

        Raises :class:`NoFreeBlocks` for a request the pool can *never*
        hold (capped worst-case demand > ``num_blocks``) — a loud
        misconfiguration error instead of an admission loop that spins
        forever.
        """
        worst = self.blocks_written(prompt_len, max_new_tokens)
        if worst > self.pool.num_blocks:
            raise NoFreeBlocks(
                f"request needs {worst} blocks worst-case but the pool "
                f"holds {self.pool.num_blocks}; raise num_blocks (or "
                "lower max_len / the token budget)")
        need = worst
        if self.preemption:
            need = min(math.ceil(prompt_len / self.block_size),
                       self.blocks_per_slot)
        hits = 0
        if prompt is not None and self.cache is not None:
            hits = self.cache.match_len(
                prompt, max_blocks=(len(prompt) - 1) // self.block_size)
        evictable = self.cache.evictable if self.cache is not None else 0
        # earlier promises of this wave pin the parked blocks they adopt
        # (counted in full: a block two of them share is discounted twice,
        # which can only delay an admission by a wave, never over-promise)
        avail = (self.pool.free + max(evictable - hits - self._wave_pins, 0)
                 - sum(self._reserved) - self._wave_hold)
        if need - hits <= avail:
            self._wave_hold += max(need - hits, 0)
            self._wave_pins += hits
            return True
        return False

    # -- lifecycle -----------------------------------------------------------
    def _alloc(self) -> int:
        try:
            return self.pool.alloc()
        except NoFreeBlocks:
            if self.cache is not None and self.cache.evict(1):
                return self.pool.alloc()
            raise

    def admit(self, slot: int, prompt: Sequence[int],
              max_new_tokens: int) -> int:
        """Assign blocks for ``prompt`` to ``slot``; returns the adopted
        prefix length (tokens whose KV is already in the pool — zero
        prefill FLOPs for them). Hits are capped at the prompt's *full*
        blocks minus one token, so at least the last prompt token is
        always prefilled (its logits seed sampling) and a shared block is
        never written into."""
        assert not self._slot_blocks[slot], f"slot {slot} already assigned"
        hits: List[int] = []
        if self.cache is not None:
            self.prefix_lookups += 1
            hits = self.cache.match(
                prompt, max_blocks=(len(prompt) - 1) // self.block_size)
            if hits:
                self.prefix_hits += 1
                self.prefix_hit_tokens += len(hits) * self.block_size
        n_prompt = math.ceil(len(prompt) / self.block_size)
        bids = hits + [self._alloc() for _ in range(n_prompt - len(hits))]
        self.tables[slot, :n_prompt] = bids
        self._slot_blocks[slot] = bids
        # optimistic admission keeps no generation reservation — decode
        # growth competes for free blocks and the engine preempts on miss
        self._reserved[slot] = 0 if self.preemption else (
            self.blocks_written(len(prompt), max_new_tokens) - n_prompt)
        self.peak_in_use = max(self.peak_in_use, self.pool.in_use)
        return len(hits) * self.block_size

    def ensure_block(self, slot: int, write_pos: int) -> None:
        """Grow ``slot``'s table so the decode write at absolute position
        ``write_pos`` has a physical block (call before every decode
        step; a no-op unless the position opens a new logical block)."""
        j = write_pos // self.block_size
        blocks = self._slot_blocks[slot]
        assert blocks, f"slot {slot} has no blocks (not admitted?)"
        if j < len(blocks):
            return
        assert j == len(blocks), (j, len(blocks))
        bid = self._alloc()
        blocks.append(bid)
        self.tables[slot, j] = bid
        self._reserved[slot] = max(self._reserved[slot] - 1, 0)
        self.peak_in_use = max(self.peak_in_use, self.pool.in_use)

    def rollback(self, slot: int, tokens_kept: int) -> int:
        """Truncate ``slot`` to its first ``tokens_kept`` cache cells and
        free the now-dead tail blocks; returns how many blocks freed.

        Speculative verification writes draft KVs optimistically at
        positions ``resident..resident+k``; on rejection the accepted
        prefix keeps its blocks untouched (append-only discipline) and
        only whole blocks past ``ceil(tokens_kept / block_size)`` return
        to the pool. Stale cells inside the kept tail block are never
        attended (``kv_len`` masks them) and are overwritten before the
        slot's length grows past them. Radix-adopted prefix blocks sit
        below the kept range, and even an explicit rollback over one
        only drops the slot's reference — the cache's own refcount keeps
        shared blocks alive. With preemption off the freed blocks return
        to this slot's worst-case reservation so admission accounting
        stays exact.
        """
        keep = math.ceil(tokens_kept / self.block_size)
        blocks = self._slot_blocks[slot]
        assert blocks and tokens_kept >= 1, (slot, tokens_kept)
        n_freed = len(blocks) - keep
        if n_freed <= 0:
            return 0
        for j in range(keep, len(blocks)):
            self.tables[slot, j] = self.trash
            self.pool.release(blocks[j])
        del blocks[keep:]
        if not self.preemption:
            self._reserved[slot] += n_freed
        return n_freed

    def release(self, slot: int, tokens_written: Sequence[int]) -> None:
        """Drop ``slot``'s references: full blocks are parked in the
        prefix cache keyed by the tokens actually written; the partial
        tail block (and everything, with the cache off) frees. The slot's
        table row resets to the trash block."""
        bids = self._slot_blocks[slot]
        if self.cache is not None and bids:
            n_full = len(tokens_written) // self.block_size
            self.cache.insert(list(tokens_written)[:n_full * self.block_size],
                              bids[:n_full])
        for bid in bids:
            self.pool.release(bid)
        self._slot_blocks[slot] = []
        self._reserved[slot] = 0
        self.tables[slot, :] = self.trash

    # -- stats ---------------------------------------------------------------
    @property
    def live_blocks(self) -> int:
        """Blocks referenced by running requests (excludes parked-only)."""
        return len({b for bl in self._slot_blocks for b in bl})

    def stats(self) -> Dict[str, float]:
        return {
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": self.prefix_hits / max(self.prefix_lookups, 1),
            "prefill_tokens_saved": self.prefix_hit_tokens,
            "peak_blocks_in_use": self.peak_in_use,
            "num_blocks": self.pool.num_blocks,
        }
