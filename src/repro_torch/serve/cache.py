"""Bounded, thread-safe LRU caches for the serving layer.

``PlanCache`` maps query fingerprints to compiled plans (one per engine, so
keys never cross graphs).  ``ResultCache`` maps ``(fingerprint,
graph_version)`` to finished ``QueryResult``s; bumping the graph version on
a dataset (or calling :meth:`ResultCache.invalidate`) retires stale entries
without touching the plan cache — plans stay valid across data updates that
preserve the schema, results do not.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Hashable


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    inserts: int = 0
    evictions: int = 0
    invalidations: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "inserts": self.inserts, "evictions": self.evictions,
                "invalidations": self.invalidations,
                "hit_rate": round(self.hit_rate, 4)}


class LRUCache:
    """Thread-safe LRU with hit/miss/eviction accounting."""

    def __init__(self, capacity: int = 128):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = capacity
        self._data: OrderedDict[Hashable, Any] = OrderedDict()
        self._lock = threading.RLock()
        self.stats = CacheStats()

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def get(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.stats.hits += 1
                return self._data[key]
            self.stats.misses += 1
            return default

    def peek(self, key: Hashable, default: Any = None) -> Any:
        """Read without touching recency or stats."""
        with self._lock:
            return self._data.get(key, default)

    def put(self, key: Hashable, value: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self._data[key] = value
                return
            self._data[key] = value
            self.stats.inserts += 1
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.stats.evictions += 1

    def pop(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            return self._data.pop(key, default)

    def clear(self) -> None:
        with self._lock:
            self.stats.invalidations += len(self._data)
            self._data.clear()

    def keys(self) -> list:
        with self._lock:
            return list(self._data.keys())

    def snapshot(self) -> dict:
        with self._lock:
            return {"size": len(self._data), "capacity": self.capacity,
                    **self.stats.snapshot()}


class PlanCache(LRUCache):
    """Fingerprint -> CompiledQuery (per engine/graph)."""

    def __init__(self, capacity: int = 256):
        super().__init__(capacity)


class ResultCache(LRUCache):
    """(fingerprint, graph_version) -> QueryResult, with explicit
    invalidation and a row cap so one huge result can't pin the cache.

    ``invalidate(v)`` retires every generation ``<= v`` and raises a
    *watermark*: later ``put`` calls for retired generations are refused.
    Without the watermark there is a lost-invalidation race — a query that
    captured version ``v`` before an update finishes executing after
    ``invalidate(v)`` ran and re-inserts a stale result under a key no
    future invalidation will ever visit."""

    def __init__(self, capacity: int = 512, max_result_rows: int = 200_000):
        super().__init__(capacity)
        self.max_result_rows = max_result_rows
        self._min_version = 0  # smallest graph version still cacheable

    def put(self, key: Hashable, value: Any) -> None:
        rows = getattr(value, "rows", None)
        if rows is not None and rows.shape[0] > self.max_result_rows:
            return
        if (isinstance(key, tuple) and len(key) == 2
                and isinstance(key[1], int)):
            with self._lock:
                if key[1] < self._min_version:
                    return  # a concurrent invalidation already retired it
        super().put(key, value)

    def invalidate(self, graph_version: int | None = None) -> int:
        """Drop entries up to and including ``graph_version`` (or
        everything), and refuse late inserts for retired generations."""
        with self._lock:
            if graph_version is None:
                n = len(self._data)
                self._data.clear()
            else:
                self._min_version = max(self._min_version, graph_version + 1)
                stale = [k for k in self._data
                         if isinstance(k, tuple) and len(k) == 2
                         and isinstance(k[1], int)
                         and k[1] <= graph_version]
                for k in stale:
                    del self._data[k]
                n = len(stale)
            self.stats.invalidations += n
            return n
