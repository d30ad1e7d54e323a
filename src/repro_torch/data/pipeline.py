"""Deterministic sharded data pipeline with background prefetch.

A copy of `repro/data/pipeline.py` (numpy only): the port imports nothing of
the JAX package, and its batches are bit-identical to the JAX package's.

Synthetic + memory-mapped binary token sources behind one iterator:
  * per-host sharding: host h of H reads example stream indices ≡ h (mod H)
  * deterministic: (seed, step) → batch, independent of restart point, so
    checkpoint/resume replays the exact stream (fault-tolerance invariant,
    tested in tests/test_data.py)
  * double-buffered prefetch thread keeps the accelerator fed.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    host_id: int = 0
    n_hosts: int = 1
    seed: int = 0
    path: Optional[str] = None     # memmapped .bin of uint16/uint32 tokens
    token_dtype: str = "uint16"

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class TokenSource:
    """step → (host_batch, seq_len+1) tokens, deterministically."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mm = None
        if cfg.path:
            self._mm = np.memmap(cfg.path, dtype=cfg.token_dtype, mode="r")
            self._n_tokens = self._mm.shape[0]

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        # global example index space: step-major, host-sharded
        base = step * cfg.global_batch + cfg.host_id * cfg.host_batch
        idx = base + np.arange(cfg.host_batch, dtype=np.int64)
        if self._mm is not None:
            toks = self._window_from_file(idx)
        else:
            toks = self._synthetic(idx)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def _synthetic(self, idx: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        out = np.empty((len(idx), cfg.seq_len + 1), np.int64)
        for r, i in enumerate(idx):
            rng = np.random.Generator(np.random.Philox(key=cfg.seed, counter=i))
            # zipf-ish synthetic text: heavy-tailed token distribution
            u = rng.random(cfg.seq_len + 1)
            out[r] = (cfg.vocab_size * u ** 3).astype(np.int64) % cfg.vocab_size
        return out

    def _window_from_file(self, idx: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        span = cfg.seq_len + 1
        n_windows = (self._n_tokens - 1) // span
        out = np.empty((len(idx), span), np.int64)
        for r, i in enumerate(idx):
            w = int(i % n_windows)
            out[r] = np.asarray(self._mm[w * span:(w + 1) * span], np.int64)
        return out


class PrefetchIterator:
    """Background-thread double buffering over a TokenSource."""

    def __init__(self, source: TokenSource, start_step: int = 0, depth: int = 2):
        self.source = source
        self.step = start_step
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(s)
            while not self._stop.is_set():
                try:
                    self.q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self.q.get()
        self.step = step + 1
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
