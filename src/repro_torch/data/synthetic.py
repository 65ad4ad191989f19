"""Synthetic data with learnable structure: a copy of ``BigramLM`` from
``repro/data/synthetic.py`` (numpy only; the port imports nothing of
``repro``), so both packages draw the same batches for a seed.

* ``BigramLM``: a token stream from a fixed random bigram chain. A model
  that learns drives the loss well below the unigram entropy, so optimizer
  and precision experiments show real learning curves, not noise.

The CLIP and sequence-to-sequence generators come with their model
families.
"""
from __future__ import annotations

import numpy as np


class BigramLM:
    """Deterministic synthetic LM stream."""

    def __init__(self, vocab_size: int, seed: int = 0, temperature: float = 1.0):
        rng = np.random.RandomState(seed)
        logits = rng.randn(vocab_size, vocab_size) * 2.0 / temperature
        self.P = np.exp(logits - logits.max(1, keepdims=True))
        self.P /= self.P.sum(1, keepdims=True)
        self.vocab_size = vocab_size
        self._rng = np.random.RandomState(seed + 1)

    def batch(self, batch_size: int, seq_len: int):
        """Returns dict(tokens (B,S) int32, labels (B,S) int32)."""
        toks = np.zeros((batch_size, seq_len + 1), np.int32)
        toks[:, 0] = self._rng.randint(0, self.vocab_size, batch_size)
        # vectorized chain sampling via per-step gumbel trick
        for t in range(seq_len):
            p = self.P[toks[:, t]]                       # (B, V)
            u = self._rng.rand(batch_size, 1)
            toks[:, t + 1] = (p.cumsum(1) > u).argmax(1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def entropy_floor(self) -> float:
        """Mean conditional entropy of the chain — the loss floor."""
        h = -(self.P * np.log(np.maximum(self.P, 1e-12))).sum(1)
        return float(h.mean())
