"""LRU cache for piece -> token-id lists.

Semantics mirror the reference caches: C# ``LruCache`` (thread-safe,
`Tokenizer_C#/TokenizerLib/Utils/LRUCache.cs:7-137`) and TS ``LRUCache``
(`tokenizer_ts/src/lru.ts:13-85`).  ``get`` refreshes recency, ``set``
inserts/updates and evicts the least-recently-used entry past capacity.

Implementation is an ``OrderedDict`` under a lock (the C# variant is the
thread-safe one; host-side pipelines here may feed the packer from
multiple threads).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Generic, Hashable, Optional, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")

__all__ = ["LRUCache", "DEFAULT_CACHE_SIZE", "BUILDER_CACHE_SIZE"]

#: Engine-constructor default (TikTokenizer.cs:34, tikTokenizer.ts:84).
DEFAULT_CACHE_SIZE = 4096
#: Size the builder passes (TokenizerBuilder.cs:210, tokenizerBuilder.ts:296).
BUILDER_CACHE_SIZE = 8192


class LRUCache(Generic[K, V]):
    """O(1) get/set LRU keyed by hashable keys (piece strings)."""

    def __init__(self, capacity: int = DEFAULT_CACHE_SIZE):
        if capacity <= 0:
            raise ValueError("LRU capacity must be positive")
        self.capacity = capacity
        self._data: "OrderedDict[K, V]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: K) -> Optional[V]:
        """Return the cached value and mark it most-recently-used."""
        with self._lock:
            try:
                self._data.move_to_end(key)
            except KeyError:
                return None
            return self._data[key]

    def set(self, key: K, value: V) -> None:
        """Insert/update; evict the LRU entry if over capacity."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = value
            if len(self._data) > self.capacity:
                self._data.popitem(last=False)

    # C#-parity aliases (LRUCache.cs Lookup/Add).
    def lookup(self, key: K):
        v = self.get(key)
        return (v is not None), v

    def add(self, key: K, value: V) -> None:
        self.set(key, value)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
