"""Deterministic synthetic token pipeline with background prefetch.

Real deployments swap in a tokenized corpus reader; everything downstream
(shapes, sharding, determinism contract) is identical.  Batches are a pure
function of (seed, step), so restart-after-failure resumes bit-identically —
the property the checkpoint/restart test asserts.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    # structured synthetic data: repeated n-grams make the LM loss actually
    # decrease, so convergence tests have signal
    ngram: int = 8


def batch_at(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The batch for a given step (pure function — restart-safe)."""
    rng = np.random.default_rng((cfg.seed << 32) ^ step)
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    # n-gram language: each sequence repeats a per-sequence n-gram with noise
    grams = rng.integers(1, v, size=(b, cfg.ngram))
    reps = -(-s // cfg.ngram) + 1
    seq = np.tile(grams, (1, reps))[:, : s + 1]
    noise = rng.random((b, s + 1)) < 0.05
    seq = np.where(noise, rng.integers(1, v, size=(b, s + 1)), seq)
    return {
        'tokens': seq[:, :-1].astype(np.int32),
        'labels': seq[:, 1:].astype(np.int32),
    }


class Prefetcher:
    """Double-buffered host pipeline: a background thread stays one batch
    ahead so host data generation overlaps device compute."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = batch_at(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
