"""Deterministic, resumable synthetic LM data (the port's own copy of the
reference's ``data/pipeline.py`` LM stream; numpy only).

* **Stateless addressing**: every batch is a pure function of
  ``(seed, step)``; the only pipeline state is the step cursor saved in the
  checkpoint, so restarts resume bit-exactly.
* **Host sharding**: ``batch_at(step, shard, n_shards)`` returns just this
  host's slice of the global batch.
* **Straggler hook**: ``PrefetchIterator`` overlaps host batch synthesis
  with device steps on a worker thread and, past a deadline, reports the
  stall instead of blocking silently.

The stream is a noisy affine-recurrence language (the next token mostly
determined by the previous one), so cross-entropy falls measurably within
a few hundred steps, with no downloads.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator

import numpy as np

__all__ = ["LMStreamConfig", "SyntheticLM", "PrefetchIterator"]


@dataclasses.dataclass(frozen=True)
class LMStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05     # fraction of tokens replaced by uniform noise


class SyntheticLM:
    """Markov-ish synthetic token stream with deterministic addressing."""

    def __init__(self, cfg: LMStreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self._mult = int(rng.integers(3, 97)) | 1          # odd multiplier
        self._add = int(rng.integers(1, v))

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1) -> dict[str, Any]:
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError("global_batch must divide by n_shards")
        per = cfg.global_batch // n_shards
        rng = np.random.default_rng((cfg.seed, step, shard))
        v = cfg.vocab_size
        seq = np.empty((per, cfg.seq_len + 1), np.int64)
        seq[:, 0] = rng.integers(0, v, per)
        noise_mask = rng.random((per, cfg.seq_len)) < cfg.noise
        noise_tok = rng.integers(0, v, (per, cfg.seq_len))
        for t in range(cfg.seq_len):
            nxt = (seq[:, t] * self._mult + self._add) % v
            seq[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return {
            "tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict[str, Any]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Thread-prefetching wrapper with a stall deadline (straggler hook)."""

    def __init__(self, make_batch, start_step: int = 0, depth: int = 2, timeout_s: float = 60.0):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._timeout = timeout_s
        self._stalls = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._make(step)
            self._q.put((step, batch))
            step += 1

    @property
    def stalls(self) -> int:
        return self._stalls

    def __next__(self):
        try:
            return self._q.get(timeout=self._timeout)
        except queue.Empty:
            self._stalls += 1
            raise TimeoutError(
                f"data pipeline stalled > {self._timeout}s (stall #{self._stalls}); "
                "a production deployment skips the straggler shard here"
            )

    def close(self):
        self._stop.set()
        while not self._q.empty():
            self._q.get_nowait()
