"""Host-side data pipeline: deterministic batching + prefetch, the port of
``repro/data/pipeline.py``.

Fault-tolerance contract: the pipeline is a pure function of (seed, step),
so on restart from a checkpoint at step k the iterator resumes at exactly
batch k+1 — no data is repeated or skipped (the trainer stores `step` in
the checkpoint), and the supervisor's skip is a shift of the data index.
Prefetch runs ahead on a worker thread that builds host (numpy) batches
only; ``device_put_fn`` runs in the consumer's ``__next__``, so the worker
makes no CUDA call. The JAX ``shard_batch`` waits for sharded training.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class DeterministicBatcher:
    """Wraps a synthetic source so batch(step) is reproducible."""

    def __init__(self, make_source: Callable[[int], object], seed: int = 0):
        self._make_source = make_source
        self._seed = seed

    def batch_at(self, step: int, **kw) -> Dict[str, np.ndarray]:
        src = self._make_source(self._seed + step)
        return src.batch(**kw)


class PrefetchIterator:
    """Background prefetch of host batches; ``device_put_fn`` (e.g. a copy
    onto the card) runs in the consumer."""

    def __init__(self, batch_fn: Callable[[int], Dict], start_step: int = 0,
                 device_put_fn: Optional[Callable] = None, depth: int = 2):
        self._batch_fn = batch_fn
        self._put = device_put_fn or (lambda x: x)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self._batch_fn(step)
            except Exception as e:              # surface in consumer
                self._q.put(e)
                return
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        step, batch = item
        return step, self._put(batch)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

