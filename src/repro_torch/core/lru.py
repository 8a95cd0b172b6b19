"""Bounded, thread-safe LRU with hit/miss counters.

Port of ``repro/core/lru.py``: the shared machinery of the operand
:class:`~repro_torch.core.api.TransformCache` (and, once serving is
ported, its plan cache), which differ only in what they key on and what a
lookup returns.  Subclasses call the locked ``_lookup`` / ``_insert``
primitives; eviction, recency, counters and the stats / clear surface live
here once.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Optional


class LruStatsCache:
    """Base: bounded OrderedDict LRU under a lock, counting hits / misses.

    Lookups refresh recency and count a hit; inserts count a miss and
    evict the least-recently-used entries beyond capacity.  Builds happen
    outside the lock (they may queue device work), so two threads can race
    to build the same key; the last write wins, which is benign for the
    pure-function values cached here.
    """

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def _lookup(self, key) -> Optional[Any]:
        """The cached value for key (refreshing recency, counting a hit),
        or None on absence (not counted: the caller counts the miss at
        insert time, after the build succeeded)."""
        with self._lock:
            value = self._entries.get(key)
            if value is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            return value

    def _insert(self, key, value) -> None:
        """Insert a freshly built value, counting the miss and evicting
        beyond capacity."""
        with self._lock:
            self.misses += 1
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def _evict(self, key) -> None:
        """Drop one key if present: weakref death callbacks use this to
        remove entries whose referent was collected."""
        with self._lock:
            self._entries.pop(key, None)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._entries), "capacity": self.capacity}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0


__all__ = ["LruStatsCache"]
