"""Synthetic data with learnable structure: copies of ``BigramLM``,
``SyntheticCLIP`` and ``SyntheticSeq2Seq`` from ``repro/data/synthetic.py``
(numpy only; the port imports nothing of ``repro``), so both packages draw
the same batches for a seed.

* ``BigramLM``: a token stream from a fixed random bigram chain. A model
  that learns drives the loss well below the unigram entropy, so optimizer
  and precision experiments show real learning curves, not noise.
* ``SyntheticCLIP``: image-text pairs from K latent classes (a noisy
  class prototype image, the class's token string with a few tokens
  corrupted), so contrastive accuracy rises as CLIP learns.
* ``SyntheticSeq2Seq``: encoder frames and decoder targets, the targets a
  fixed function of a latent id hidden in the frames (the enc-dec
  family's stream).
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


class SyntheticCLIP:
    """Procedural image-text pairs with K latent classes."""

    def __init__(self, image_size: int, text_ctx: int, text_vocab: int,
                 n_classes: int = 32, seed: int = 0, noise: float = 0.3):
        rng = np.random.RandomState(seed)
        self.protos = rng.randn(n_classes, image_size, image_size, 3) \
            .astype(np.float32)
        self.texts = rng.randint(2, text_vocab, (n_classes, text_ctx)) \
            .astype(np.int32)
        self.n_classes = n_classes
        self.noise = noise
        self.text_vocab = text_vocab
        self._rng = np.random.RandomState(seed + 1)

    def batch(self, batch_size: int):
        cls = self._rng.randint(0, self.n_classes, batch_size)
        imgs = self.protos[cls] + self.noise * self._rng.randn(
            batch_size, *self.protos.shape[1:]).astype(np.float32)
        txts = self.texts[cls].copy()
        # corrupt a few text positions with noise tokens
        n_corrupt = max(1, txts.shape[1] // 8)
        for i in range(batch_size):
            pos = self._rng.randint(0, txts.shape[1], n_corrupt)
            txts[i, pos] = self._rng.randint(2, self.text_vocab, n_corrupt)
        return {"images": imgs, "texts": txts, "class_ids": cls}

    def class_prototype_batch(self):
        """One clean (image, text) per class — for zero-shot eval."""
        return {"images": self.protos.copy(), "texts": self.texts.copy(),
                "class_ids": np.arange(self.n_classes)}


class SyntheticSeq2Seq:
    """Frames + target tokens where targets are a deterministic function of
    a latent id embedded in the frames (enc-dec smoke/bench data)."""

    def __init__(self, d_model: int, vocab_size: int, n_programs: int = 16,
                 seed: int = 0):
        rng = np.random.RandomState(seed)
        self.keys = rng.randn(n_programs, d_model).astype(np.float32)
        self.progs = rng.randint(2, vocab_size, (n_programs, 512)) \
            .astype(np.int32)
        self.n_programs = n_programs
        self._rng = np.random.RandomState(seed + 1)

    def batch(self, batch_size: int, n_frames: int, seq_len: int):
        pid = self._rng.randint(0, self.n_programs, batch_size)
        frames = (self.keys[pid][:, None, :]
                  + 0.3 * self._rng.randn(batch_size, n_frames,
                                          self.keys.shape[1]).astype(np.float32))
        toks = self.progs[pid][:, :seq_len + 1]
        return {"frames": frames.astype(np.float32),
                "tokens": toks[:, :-1], "labels": toks[:, 1:]}
