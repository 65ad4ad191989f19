"""Model-free draft proposers for speculative decoding.

A copy of the JAX package's ``repro/serve/spec.py``.

Prompt-lookup / n-gram drafting: the proposer scans the request's own
token history (prompt + generated so far) for an earlier occurrence of
the current trailing n-gram and proposes the tokens that followed it.
No draft model, no device work — drafting is pure host python, and the
engine verifies all proposed tokens in one k-query ``paged_prefill``
call (DESIGN.md §12).

Greedy verification makes acceptance exact: a draft token is kept only
if it equals the model's argmax at that position, so generations are
token-for-token identical to ``spec_mode="off"`` regardless of how
often the proposer is wrong.
"""
from __future__ import annotations

from typing import List, Sequence

__all__ = ["NgramProposer"]


class NgramProposer:
    """Propose draft tokens by prompt lookup.

    Matches the trailing ``n``-gram of ``history`` (for ``n`` from
    ``max_ngram`` down to ``min_ngram``) against earlier positions and
    returns up to ``k`` tokens that followed the **latest** earlier
    occurrence — recent context predicts the continuation better than
    distant context when both match.

    >>> p = NgramProposer(k=4, max_ngram=3, min_ngram=1)
    >>> p.propose([1, 2, 3, 1, 2], 4)        # "1 2" seen before -> "3 1 2"
    [3, 1, 2]
    >>> p.propose([5, 6, 5, 7, 5], 4)        # falls back to the 1-gram "5"
    [7, 5]
    >>> p.propose([1, 2, 3, 4], 4)           # no repeated n-gram
    []
    >>> p.propose([], 4)                     # empty history
    []
    >>> p.propose([1, 2, 3, 1, 2], 1)        # caller clamp wins
    [3]
    >>> NgramProposer(k=4, min_ngram=2).propose([5, 6, 5, 7, 5], 4)
    []
    """

    def __init__(self, k: int = 4, max_ngram: int = 3, min_ngram: int = 1):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got {min_ngram}..{max_ngram}")
        self.k = int(k)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, history: Sequence[int], max_tokens: int) -> List[int]:
        """Return up to ``min(self.k, max_tokens)`` draft tokens.

        ``max_tokens`` is the engine's per-slot clamp (budget remaining,
        cache edge); an empty list means "no drafts this step" and the
        engine falls back to a plain one-token decode.
        """
        cap = min(self.k, int(max_tokens))
        L = len(history)
        if cap < 1 or L < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            pattern = tuple(history[L - n:])
            # Latest earlier occurrence with a non-empty continuation;
            # i == L - n is the trailing n-gram itself, so start below it.
            for i in range(L - n - 1, -1, -1):
                if tuple(history[i:i + n]) == pattern:
                    return [int(t) for t in history[i + n:i + n + cap]]
        return []
