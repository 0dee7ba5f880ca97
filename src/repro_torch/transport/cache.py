"""Exact-key LRU caches for the Zipf head of the query stream.

Real ANN query streams are head-heavy (rank-frequency roughly Zipf — the
workload analyses PAPERS.md cites), so a small exact-key cache in the
master absorbs the hottest queries without touching a worker.  Two caches
share one LRU core:

* :class:`ResultCache` — ``(query bytes, k, n_probe) -> (dists, ids)``.
  Exact-key only: a hit returns the byte-identical payload a worker
  produced earlier for the same request parameters, so cached results are
  correct *by construction* — no approximate matching, no staleness model
  beyond the generation tag (the cache is flushed on engine swaps).
* :class:`RouteMemo` — ``query bytes -> worker id``: a routing hint that
  sends a repeated query back to the worker whose caches and predictor
  are already warm for it, complementing the centroid-affinity router
  with zero geometry work on the hot path.

Both live inside :class:`~repro_torch.transport.core.MasterCore` and
mutate only on core events, so a replayed event stream reproduces the
exact same hit/miss sequence — cache state never needs recording.

The port's copy of the JAX package's ``transport/cache.py``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable

import numpy as np


class LruCache:
    """Bounded mapping with least-recently-used eviction (get refreshes)."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._d: OrderedDict[Hashable, Any] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d

    def get(self, key: Hashable) -> Any | None:
        try:
            self._d.move_to_end(key)
        except KeyError:
            self.misses += 1
            return None
        self.hits += 1
        return self._d[key]

    def put(self, key: Hashable, value: Any) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        if len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._d.clear()

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"size": len(self._d), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": round(self.hits / total, 4) if total else 0.0}


def result_key(q: np.ndarray, k: int, n_probe: int) -> tuple:
    """Exact-key identity of one request's results: the query's raw bytes
    (bit-exact — two queries differing in the last mantissa bit are
    different keys) plus the retrieval parameters that shape the answer."""
    arr = np.ascontiguousarray(q)
    return (arr.tobytes(), arr.dtype.name, int(k), int(n_probe))


class ResultCache:
    """LRU of completed result payloads, keyed by :func:`result_key`."""

    def __init__(self, capacity: int = 256):
        self._lru = LruCache(capacity)

    def get(self, q: np.ndarray, k: int,
            n_probe: int) -> tuple[np.ndarray, np.ndarray] | None:
        return self._lru.get(result_key(q, k, n_probe))

    def put(self, q: np.ndarray, k: int, n_probe: int,
            dists: np.ndarray, ids: np.ndarray) -> None:
        # copies: cached payloads must be immune to caller-side mutation
        self._lru.put(result_key(q, k, n_probe),
                      (np.array(dists, copy=True), np.array(ids, copy=True)))

    def clear(self) -> None:
        self._lru.clear()

    def stats(self) -> dict:
        return self._lru.stats()


class RouteMemo:
    """LRU routing hint: last worker that served each exact query."""

    def __init__(self, capacity: int = 1024):
        self._lru = LruCache(capacity)

    def get(self, q: np.ndarray) -> int | None:
        arr = np.ascontiguousarray(q)
        return self._lru.get((arr.tobytes(), arr.dtype.name))

    def put(self, q: np.ndarray, wid: int) -> None:
        arr = np.ascontiguousarray(q)
        self._lru.put((arr.tobytes(), arr.dtype.name), int(wid))

    def stats(self) -> dict:
        return self._lru.stats()
