"""Radix prefix cache: adopt already-filled KV blocks for shared prefixes.

A copy of the JAX package's ``repro/serve/paged/prefix_cache.py``.

A trie over *full* KV blocks: each node is one block of ``block_size``
token ids, children keyed by the next block's token tuple, so a lookup
walks the request's prompt block by block and returns the longest chain
of already-resident blocks. Matched blocks are adopted by refcount bump —
the new request's block table points straight at them and their tokens
are never re-prefilled (zero prefill FLOPs for the shared prefix).

Keying on the *token tuple path from the root* is equivalent to the
hash-chain scheme (hash(parent_hash, block_tokens)) vLLM uses, without
manufacturing collisions: the trie path IS the chain. Only full blocks
are cached — a partial tail block may still be written by its owner, so
sharing it would corrupt neighbours; the manager caps matches one token
short of the prompt so the last token is always re-prefilled (sampling
needs its logits).

Eviction is LRU over *unreferenced leaves*: a node whose block no request
holds (pool refcount 1 — the cache's own reference) and with no children
(children must outlive parents: a child's KV is only valid with its full
prefix resident). Evicting a leaf can expose its parent for the next
round, so reclaiming N blocks walks leaf-by-leaf.

>>> from repro_torch.serve.paged.block_pool import BlockPool
>>> pool = BlockPool(4)
>>> cache = RadixPrefixCache(pool, block_size=2)
>>> b0, b1 = pool.alloc(), pool.alloc()
>>> cache.insert([1, 2, 3, 4], [b0, b1])     # park two full blocks
>>> pool.release(b0); pool.release(b1)       # request gone; cache holds
>>> cache.match([1, 2, 3, 4, 5], max_blocks=2)   # adopts both
[0, 1]
>>> cache.match([1, 2, 9, 9], max_blocks=2)      # diverges after block 0
[0]
>>> pool.refcount(b0)                        # cache + the two matches
3
>>> cache.evict(4)                           # nothing evictable (refs held)
0
>>> pool.release(b0); pool.release(b0)       # the two adopters finish
>>> pool.release(b1)
>>> cache.evict(2)                           # leaf b1 first, then b0
2
>>> pool.free
4
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("bid", "children", "parent", "last_used",
                 "self_dirty", "n_dirty_children", "subtree_clean")

    def __init__(self, bid: Optional[int], parent: Optional["_Node"]):
        self.bid = bid
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0
        # incremental evictable accounting (see RadixPrefixCache.evictable):
        # self_dirty    — pool refcount > 1 (some request holds the block)
        # subtree_clean — neither this node nor any descendant is dirty,
        #                 i.e. the node is reclaimable (now or by cascade)
        self.self_dirty = False
        self.n_dirty_children = 0
        self.subtree_clean = False


class RadixPrefixCache:
    """Trie of parked KV blocks over a :class:`BlockPool`.

    The cache holds one pool reference per resident node; :meth:`match`
    adds one reference per adopted block on the caller's behalf (the
    caller releases it like any owned block), and :meth:`evict` drops the
    cache's reference on LRU unreferenced leaves.
    """

    def __init__(self, pool, block_size: int):
        assert block_size >= 1
        self.pool = pool
        self.block_size = block_size
        self._root = _Node(None, None)
        self._tick = 0
        self.n_nodes = 0
        # incremental evictable count: adoption and release change pool
        # refcounts outside the cache's own call surface, so the cache
        # watches the pool's refcount transitions and maintains per-node
        # clean-subtree flags plus one global counter — O(depth) per
        # transition instead of the old O(n_nodes) walk per probe.
        self._by_bid: Dict[int, _Node] = {}
        self._n_evictable = 0
        pool.subscribe(self._on_refcount)

    # -- incremental evictable bookkeeping -----------------------------------
    def _reeval(self, node: _Node) -> None:
        """Recompute ``subtree_clean`` for ``node`` and bubble any flip up
        the ancestor chain, keeping ``_n_evictable`` and every parent's
        ``n_dirty_children`` consistent."""
        while node is not self._root:
            clean = (not node.self_dirty) and node.n_dirty_children == 0
            if clean == node.subtree_clean:
                break
            node.subtree_clean = clean
            self._n_evictable += 1 if clean else -1
            node.parent.n_dirty_children += -1 if clean else 1
            node = node.parent

    def _register(self, node: _Node) -> None:
        """Track a freshly inserted node (already linked to its parent)."""
        assert node.bid not in self._by_bid, f"block {node.bid} in trie twice"
        self._by_bid[node.bid] = node
        node.self_dirty = self.pool.refcount(node.bid) > 1
        node.n_dirty_children = 0
        node.subtree_clean = not node.self_dirty
        if node.subtree_clean:
            self._n_evictable += 1
        else:
            node.parent.n_dirty_children += 1
            self._reeval(node.parent)

    def _unregister(self, node: _Node) -> None:
        """Stop tracking a node being evicted (still linked to parent)."""
        del self._by_bid[node.bid]
        if node.subtree_clean:
            self._n_evictable -= 1
        else:
            node.parent.n_dirty_children -= 1
            self._reeval(node.parent)

    def _on_refcount(self, bid: int, refcount: int) -> None:
        """Pool watcher: a resident block's refcount crossed a boundary
        (adoption pins it, the last adopter's release unpins it)."""
        node = self._by_bid.get(bid)
        if node is None:
            return
        dirty = refcount > 1
        if dirty != node.self_dirty:
            node.self_dirty = dirty
            self._reeval(node)

    def _keys(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        bs = self.block_size
        n_full = len(tokens) // bs
        return [tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
                for j in range(n_full)]

    def _walk(self, tokens: Sequence[int], max_blocks: int) -> List[_Node]:
        node, path = self._root, []
        for key in self._keys(tokens)[:max_blocks]:
            node = node.children.get(key)
            if node is None:
                break
            path.append(node)
        return path

    # -- lookup / insert -----------------------------------------------------
    def match_len(self, tokens: Sequence[int], *, max_blocks: int) -> int:
        """Longest resident full-block chain, in blocks — no side effects
        (admission sizing uses this before committing)."""
        return len(self._walk(tokens, max_blocks))

    def match(self, tokens: Sequence[int], *, max_blocks: int) -> List[int]:
        """Adopt the longest resident chain: returns its block ids with
        one pool reference each added for the caller, and refreshes the
        chain's LRU stamp."""
        path = self._walk(tokens, max_blocks)
        self._tick += 1
        for node in path:
            node.last_used = self._tick
            self.pool.retain(node.bid)
        return [n.bid for n in path]

    def insert(self, tokens: Sequence[int], bids: Sequence[int]) -> None:
        """Park ``bids`` (one per full block of ``tokens``) — the cache
        retains each *newly created* node's block. A prefix that is
        already resident keeps its existing blocks (the caller's
        duplicates just lose their request reference and free); the walk
        stops at the first divergence past residency, since a child block
        is only valid on top of its exact parent chain."""
        keys = self._keys(tokens)
        assert len(keys) == len(bids), (len(keys), len(bids))
        self._tick += 1
        node = self._root
        for key, bid in zip(keys, bids):
            child = node.children.get(key)
            if child is None:
                child = _Node(int(bid), node)
                node.children[key] = child
                self.pool.retain(bid)
                self.n_nodes += 1
                self._register(child)
            child.last_used = self._tick
            node = child

    # -- eviction ------------------------------------------------------------
    def _evictable_leaves(self) -> List[Tuple[Tuple[int, ...], _Node]]:
        out = []

        def rec(node: _Node):
            for key, child in node.children.items():
                if child.children:
                    rec(child)
                elif self.pool.refcount(child.bid) == 1:
                    out.append((key, child))
        rec(self._root)
        return out

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` pool blocks, LRU unreferenced leaves
        first (cascading into exposed parents). Returns how many blocks
        actually reached the free list."""
        freed = 0
        while freed < n_blocks:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            key, node = min(leaves, key=lambda kn: kn[1].last_used)
            del node.parent.children[key]
            self._unregister(node)
            self.pool.release(node.bid)
            self.n_nodes -= 1
            freed += 1
        return freed

    @property
    def evictable(self) -> int:
        """Blocks reclaimable right now *or after cascading* — every
        resident node whose subtree holds no outside references. Used by
        admission accounting (``PagedCacheManager.fits``), once per
        queued request per wave, so this is O(1): the count is maintained
        incrementally via pool refcount-transition callbacks (adoption
        and release happen outside the cache's call surface) plus
        insert/evict hooks. :meth:`recount` is the O(n_nodes) oracle the
        consistency test checks this against."""
        return self._n_evictable

    def recount(self) -> int:
        """Recompute :attr:`evictable` from scratch by walking the trie —
        the pre-incremental O(n_nodes) definition, kept as the assertion
        oracle for the incremental accounting."""
        count = 0

        def rec(node: _Node) -> bool:
            """True iff the whole subtree is cache-only; counts it."""
            nonlocal count
            clean = all([rec(c) for c in node.children.values()])
            if node is self._root:
                return clean
            if clean and self.pool.refcount(node.bid) == 1:
                count += 1
                return True
            return False

        rec(self._root)
        return count
