"""Deterministic synthetic LM data pipeline (a copy of the JAX package's
``train/data.py``: numpy-seeded, so one seed gives the same batches in
both packages). One change: the reference's prefetch thread drops the
batch it holds when the queue stays full for half a second and samples
another, so a consumer slower than that gets another stream; here the
thread keeps its batch until it is taken, and the stream is the seed's
alone.

Generates a zipf-distributed token stream with local bigram structure
(so loss actually decreases during the example training runs), sharded
by (process, data-parallel rank) and double-buffered via a background
prefetch thread — the shape of a real pipeline without external data.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, shard: int = 0, num_shards: int = 1,
                 prefetch: int = 2):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_size
        self.rng = np.random.default_rng(seed * num_shards + shard + 1)
        # fixed random bigram table: each token has 8 likely successors
        g = np.random.default_rng(seed)
        self.succ = g.integers(0, vocab_size, size=(vocab_size, 8))
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _sample_batch(self) -> np.ndarray:
        B, S = self.batch, self.seq
        toks = np.empty((B, S), np.int32)
        zipf = np.minimum(self.rng.zipf(1.3, size=(B,)), self.vocab - 1)
        toks[:, 0] = zipf
        follow = self.rng.random((B, S)) < 0.8
        choice = self.rng.integers(0, 8, size=(B, S))
        rand = self.rng.integers(0, self.vocab, size=(B, S))
        for t in range(1, S):
            nxt = self.succ[toks[:, t - 1], choice[:, t]]
            toks[:, t] = np.where(follow[:, t], nxt, rand[:, t])
        return toks

    def _fill(self):
        while not self._stop.is_set():
            batch = self._sample_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        toks = self._q.get()
        return {"tokens": toks, "labels": toks.copy()}

    def close(self):
        self._stop.set()
