"""Token data pipeline: deterministic, shardable, resumable.

A copy of ``repro.dataio.tokens`` (numpy only), so the port gives the
reference's batches bit for bit.

Two sources:
  * SyntheticTokens — per-(step, shard) PRNG-derived batches.  Deterministic
    as a function of step, so fault-tolerant resume replays the exact stream
    (no data skew after restart) and straggler requeues are idempotent.
  * MemmapCorpus    — file-backed binary corpus (uint16/uint32 tokens) read
    as strided windows; offset is a pure function of step (resumable).

A background prefetch thread keeps ``depth`` batches ahead of the consumer.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticTokens:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        tokens = rng.integers(0, self.vocab_size,
                              size=(self.global_batch, self.seq_len + 1),
                              dtype=np.int32)
        return dict(tokens=tokens[:, :-1], targets=tokens[:, 1:])


class MemmapCorpus:
    def __init__(self, path: str, seq_len: int, global_batch: int,
                 dtype=np.uint16):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.tokens_per_step = global_batch * (seq_len + 1)
        self.n_steps = len(self.data) // self.tokens_per_step

    def batch(self, step: int) -> dict:
        off = (step % self.n_steps) * self.tokens_per_step
        chunk = np.asarray(self.data[off:off + self.tokens_per_step],
                           dtype=np.int32)
        chunk = chunk.reshape(self.global_batch, self.seq_len + 1)
        return dict(tokens=chunk[:, :-1], targets=chunk[:, 1:])

    @staticmethod
    def write_synthetic(path: str, n_tokens: int, vocab: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        arr = rng.integers(0, vocab, size=(n_tokens,), dtype=np.uint16)
        arr.tofile(path)


class Prefetcher:
    """Background thread producing batches ``depth`` steps ahead."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        while True:
            yield self.q.get()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
