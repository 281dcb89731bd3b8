"""Bounded LRU of built executables, keyed by compile signature.

One cache instance can back many :class:`repro_torch.fpca.CompiledFrontend`
handles, which bounds the *total* number of live executables across every
configuration a host serves: entries are closures that own their constant
tables on the device, so LRU eviction frees them.

Counters are introspectable via :meth:`ExecutableCache.info` — the
``functools.lru_cache``-style :class:`CacheInfo` that
``CompiledFrontend.cache_info()`` surfaces, and the mechanism the
reprogram-without-recompile contract is asserted against (``misses`` must
not move across a ``reprogram()``).  ``info(verbose=True)`` adds the
telemetry-grade breakdown: per-signature hit/miss counts for every key the
cache has ever seen, plus a bounded, ordered eviction history — enough to
see exactly *which* executable thrashed when a fleet overflows capacity.
"""

from __future__ import annotations

import collections
from typing import Callable, NamedTuple

__all__ = ["CacheInfo", "CacheInfoVerbose", "ExecutableCache"]


class CacheInfo(NamedTuple):
    hits: int
    misses: int
    evictions: int
    currsize: int
    maxsize: int


class CacheInfoVerbose(NamedTuple):
    hits: int
    misses: int
    evictions: int
    currsize: int
    maxsize: int
    # per-signature (hits, misses) for every key ever requested, insertion
    # ordered; keys currently resident appear in `resident` in LRU order
    # (least recently used first).
    by_key: dict
    resident: tuple
    # least-recent-first record of evicted keys, bounded by eviction_log_cap.
    eviction_log: tuple


class ExecutableCache:
    """Bounded LRU: ``get(key, build)`` returns the cached executable or
    builds, inserts and (on overflow) evicts the least recently used."""

    #: retain at most this many eviction-history entries (oldest dropped).
    eviction_log_cap = 64

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._entries: collections.OrderedDict[tuple, Callable] = (
            collections.OrderedDict()
        )
        # key -> [hits, misses]; insertion ordered, never evicted (bounded
        # in practice by the signature space a process compiles).
        self._by_key: dict[tuple, list[int]] = {}
        self._eviction_log: collections.deque[tuple] = collections.deque(
            maxlen=self.eviction_log_cap
        )

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        return key in self._entries

    def get(self, key: tuple, build: Callable[[], Callable]) -> Callable:
        per = self._by_key.setdefault(key, [0, 0])
        if key in self._entries:
            self._entries.move_to_end(key)
            self.hits += 1
            per[0] += 1
            return self._entries[key]
        self.misses += 1
        per[1] += 1
        fn = build()
        self._entries[key] = fn
        if len(self._entries) > self.capacity:
            evicted, _ = self._entries.popitem(last=False)
            self.evictions += 1
            self._eviction_log.append(evicted)
        return fn

    def info(self, verbose: bool = False) -> CacheInfo | CacheInfoVerbose:
        if not verbose:
            return CacheInfo(
                hits=self.hits,
                misses=self.misses,
                evictions=self.evictions,
                currsize=len(self._entries),
                maxsize=self.capacity,
            )
        return CacheInfoVerbose(
            hits=self.hits,
            misses=self.misses,
            evictions=self.evictions,
            currsize=len(self._entries),
            maxsize=self.capacity,
            by_key={k: (h, m) for k, (h, m) in self._by_key.items()},
            resident=tuple(self._entries.keys()),
            eviction_log=tuple(self._eviction_log),
        )

    def counters(self) -> tuple[int, int, int]:
        """(hits, misses, evictions) snapshot — for delta-based mirroring."""
        return (self.hits, self.misses, self.evictions)
