"""Synthetic token pipeline: seeded, deterministic, restart-exact (the
port's copy of the reference's ``train/data.py``; numpy, no tensors).

The pipeline must (a) never be the straggler: batches are generated ahead
on a host thread, and (b) resume bit-exactly after a restart: batch
contents are a pure function of (seed, step), so `skip_to(step)` is O(1),
with no state to replay.

The generator produces a Zipf-ish unigram stream with a Markov flavor so
the LM loss has learnable structure (pure uniform tokens give a constant
loss floor, useless for convergence tests).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, frontend_tokens: int = 0,
                 d_model: int = 0, zipf_a: float = 1.3):
        self.vocab = vocab
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.p0 = frontend_tokens
        self.d_model = d_model
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        probs = ranks ** -zipf_a
        self.probs = probs / probs.sum()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step): the restart-exactness contract."""
        rng = np.random.default_rng((self.seed << 32) ^ step)
        s_tok = self.seq - self.p0
        # order-1 structure: token t+1 = f(token t) half the time
        base = rng.choice(self.vocab, size=(self.batch, s_tok + 1),
                          p=self.probs)
        shifted = (base[:, :-1] * 31 + 7) % self.vocab
        coin = rng.random((self.batch, s_tok)) < 0.5
        toks = np.where(coin, shifted, base[:, 1:]).astype(np.int32)
        inputs = base[:, :-1].astype(np.int32)
        out = {"tokens": inputs[:, :s_tok],
               "labels": toks[:, :s_tok]}
        if self.p0:
            out["frontend"] = rng.standard_normal(
                (self.batch, self.p0, self.d_model)).astype(np.float32)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Host-side prefetch thread: keeps ``depth`` batches ready so device
    steps never wait on generation (compute/host overlap)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
