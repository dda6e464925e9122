"""LRU cache for decode matrices, keyed by erasure signature.

Re-creates the role of the reference ISA plugin's decoding-table cache
(src/erasure-code/isa/ErasureCodeIsaTableCache.h:35-63, default 2516
entries): inverting the k x k sub-generator per erasure pattern is the
expensive host-side step, and real clusters see few distinct patterns at a
time, so recovered matrices are reused across stripes.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Hashable

DEFAULT_CAPACITY = 2516


class DecodeTableCache:
    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self._capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable):
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key]
            self.misses += 1
            return None

    def put(self, key: Hashable, value) -> None:
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self._capacity:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
