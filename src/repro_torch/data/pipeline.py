"""Deterministic, resumable synthetic data (the port's own copy of the
reference's ``data/pipeline.py`` LM stream, VWW-like images and
moving-object video; numpy only, so both packages see the same bits).

* **Stateless addressing**: every batch is a pure function of
  ``(seed, step)``; the only pipeline state is the step cursor saved in the
  checkpoint, so restarts resume bit-exactly.
* **Host sharding**: ``batch_at(step, shard, n_shards)`` returns just this
  host's slice of the global batch.
* **Straggler hook**: ``PrefetchIterator`` overlaps host batch synthesis
  with device steps on a worker thread and, past a deadline, reports the
  stall instead of blocking silently.

The LM stream is a noisy affine-recurrence language (the next token mostly
determined by the previous one), so cross-entropy falls measurably within
a few hundred steps, with no downloads.  ``SyntheticVWW`` is the FPCA
training example's labelled images.  ``SyntheticMovingObject`` is the
streaming frontend's video: a static scene with one orbiting blob, each
frame a pure function of ``(seed, t)``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator

import numpy as np

__all__ = ["LMStreamConfig", "SyntheticLM", "SyntheticVWW", "SyntheticMovingObject", "PrefetchIterator"]


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


class SyntheticVWW:
    """Visual-wake-word-like image stream for the FPCA frontend examples.

    Both classes place blobs of the *same total brightness* on the same
    clutter; what differs is **shape**: 'person' = two vertically stacked
    blobs (head over torso), 'no person' = one wide blob.  Global brightness
    is jittered per image, so intensity statistics do not separate the
    classes: the classifier has to learn spatial features through the FPCA
    frontend, which is exactly the regime where the analog non-linearity and
    quantisation matter.
    """

    def __init__(self, image_hw: tuple[int, int] = (60, 60), seed: int = 0):
        self.h, self.w = image_hw
        self.seed = seed

    def batch_at(self, step: int, batch: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        h, w = self.h, self.w
        imgs = rng.uniform(0.0, 0.30, (batch, h, w, 3)).astype(np.float32)
        labels = rng.integers(0, 2, batch).astype(np.int32)
        yy, xx = np.mgrid[0:h, 0:w]
        for i in range(batch):
            cy = rng.integers(h // 3, 2 * h // 3)
            cx = rng.integers(w // 3, 2 * w // 3)
            color = rng.uniform(0.6, 1.0, 3)
            if labels[i]:
                # head-over-torso: two stacked blobs
                parts = ((h // 10, 0, h // 8, 0.45), (-h // 8, 0, h // 14, 0.45))
            else:
                # single wide blob, matched total energy
                parts = ((0, 0, h // 6, 0.40),)
            for (dy, dx, r, amp) in parts:
                d2 = (yy - cy - dy) ** 2 + (xx - cx - dx) ** 2
                imgs[i] += (amp * np.exp(-d2 / (2.0 * r * r)))[..., None] * color
            # brightness jitter kills intensity shortcuts
            imgs[i] *= rng.uniform(0.7, 1.1)
        return {"images": np.clip(imgs, 0.0, 1.0), "labels": labels}


class SyntheticMovingObject:
    """Deterministic video stream: static cluttered scene + one moving blob.

    The streaming-frontend workload: frame-to-frame, only the pixels under
    the blob's old and new positions change, so a temporal delta gate keeps a
    small block fraction (tunable via ``radius``/``speed``).  ``frame_at(t)``
    is a pure function of ``(seed, t)`` — streams restart and shard exactly
    like the other synthetic pipelines here.
    """

    def __init__(
        self,
        image_hw: tuple[int, int] = (96, 96),
        seed: int = 0,
        radius: float = 7.0,
        speed: float = 0.17,
        amplitude: float = 0.55,
    ):
        self.h, self.w = image_hw
        self.radius = radius
        self.speed = speed
        self.amplitude = amplitude
        rng = np.random.default_rng(seed)
        # static background: low-frequency clutter, fixed for the stream
        base = rng.uniform(0.05, 0.35, (self.h // 8 + 1, self.w // 8 + 1, 3))
        self._background = np.clip(
            np.kron(base, np.ones((8, 8, 1)))[: self.h, : self.w], 0.0, 1.0
        ).astype(np.float32)
        self._yy, self._xx = np.mgrid[0 : self.h, 0 : self.w]
        self._color = rng.uniform(0.6, 1.0, 3).astype(np.float32)

    def frame_at(self, t: int) -> np.ndarray:
        """Frame ``t``: the blob orbits the scene centre."""
        cy = self.h / 2 + 0.30 * self.h * np.sin(self.speed * t)
        cx = self.w / 2 + 0.30 * self.w * np.cos(self.speed * t)
        d2 = (self._yy - cy) ** 2 + (self._xx - cx) ** 2
        blob = self.amplitude * np.exp(-d2 / (2.0 * self.radius**2))
        frame = self._background + blob[..., None].astype(np.float32) * self._color
        return np.clip(frame, 0.0, 1.0).astype(np.float32)

    def frames(self, n: int, start: int = 0):
        for t in range(start, start + n):
            yield self.frame_at(t)


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
