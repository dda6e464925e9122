"""EC read-modify-write pipeline: partial-stripe overwrites, batched.

The reference's EC write path is a read-modify-write state machine —
ECBackend::start_rmw gathers the stripes an overwrite touches,
try_reads_to_commit reads the old boundary stripes (through an
ExtentCache so in-flight data is not re-read from shards), and
ECTransaction::generate_transactions emits per-shard writes
(src/osd/ECBackend.cc:1876,1976; src/osd/ECTransaction.h:185;
src/osd/ExtentCache.h).

TPU-native shape: the stripe is the batch element.  An overwrite of any
size resolves to (a) at most two partial boundary stripes whose OLD
bytes are fetched (extent cache first, then shard reads + batched
decode if degraded), (b) a pure-Python byte merge, (c) ONE batched
device encode over every affected stripe, (d) per-shard chunk writes.
The object's at-rest layout is the reference's stripewise shard format
(stripe_info_t, src/osd/ECUtil.h:28-60): shard j holds stripe i's chunk
j at byte range [i*U, (i+1)*U).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class StripeInfo:
    """ECUtil::stripe_info_t analog: pure layout arithmetic."""
    k: int
    chunk_size: int                  # stripe_unit U

    @property
    def stripe_width(self) -> int:
        return self.k * self.chunk_size

    def stripe_count(self, size: int) -> int:
        """Stripes needed to hold `size` logical bytes."""
        if size <= 0:
            return 0
        return -(-size // self.stripe_width)

    def range_stripes(self, offset: int, length: int) -> Tuple[int, int]:
        """[first, last] stripe indices touched by the byte range."""
        if length <= 0:
            raise ValueError("length must be positive")
        return offset // self.stripe_width, \
            (offset + length - 1) // self.stripe_width

    def stripe_to_chunks(self, stripe: bytes) -> np.ndarray:
        """One stripe's bytes (padded to width) -> [k, U]."""
        buf = np.zeros(self.stripe_width, dtype=np.uint8)
        arr = np.frombuffer(stripe, dtype=np.uint8)[:self.stripe_width]
        buf[:len(arr)] = arr
        return buf.reshape(self.k, self.chunk_size)

    def chunks_to_stripe(self, chunks: np.ndarray) -> bytes:
        return chunks.reshape(-1).tobytes()


class ExtentCache:
    """Recently materialized stripes, keyed (object_key, stripe_index).

    Plays the role of the reference ExtentCache (src/osd/ExtentCache.h):
    back-to-back partial writes to the same stripes must not re-read
    their shards.  LRU-bounded by stripe count.
    """

    def __init__(self, capacity_stripes: int = 1024):
        self.capacity = capacity_stripes
        self._entries: "OrderedDict[Tuple, np.ndarray]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple) -> Optional[np.ndarray]:
        e = self._entries.get(key)
        if e is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return e

    def put(self, key: Tuple, chunks: np.ndarray) -> None:
        self._entries[key] = chunks
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def invalidate_object(self, obj_key: Tuple) -> None:
        for k in [k for k in self._entries if k[:-1] == obj_key]:
            del self._entries[k]


class RmwPipeline:
    """One overwrite -> (old-read plan, merge, batched encode)."""

    def __init__(self, codec, stripe_unit: int,
                 cache: Optional[ExtentCache] = None):
        self.codec = codec
        self.k = codec.get_data_chunk_count()
        self.m = codec.get_coding_chunk_count()
        self.sinfo = StripeInfo(self.k, stripe_unit)
        self.cache = cache if cache is not None else ExtentCache()

    def write(self, obj_key: Tuple, old_size: int, offset: int,
              data: bytes,
              read_stripe: Callable[[int], Optional[np.ndarray]]
              ) -> Tuple[Dict[int, np.ndarray], int]:
        """Plan + execute an overwrite.

        ``read_stripe(i)`` returns the OLD data chunks [k, U] of stripe
        i (decoding if degraded) or None if the stripe was never
        written.  Returns ({stripe_index: [k+m, U] new chunks}, new
        object size); the caller persists the chunks per shard.
        """
        if not data:
            return {}, old_size
        si = self.sinfo
        first, last = si.range_stripes(offset, len(data))
        W = si.stripe_width
        n_str = last - first + 1
        # assemble the affected byte span, old bytes under new ones
        span = np.zeros(n_str * W, dtype=np.uint8)
        old_stripes = si.stripe_count(old_size)
        for idx in range(first, last + 1):
            s0 = idx * W
            partial_head = idx == first and offset > s0
            partial_tail = idx == last and (offset + len(data)) < \
                min(s0 + W, max(old_size, offset + len(data)))
            if (partial_head or partial_tail) and idx < old_stripes:
                old = self.cache.get(obj_key + (idx,))
                if old is None:
                    old = read_stripe(idx)
                if old is not None:
                    span[(idx - first) * W:(idx - first + 1) * W] = \
                        old.reshape(-1)
        new = np.frombuffer(data, dtype=np.uint8)
        a = offset - first * W
        span[a:a + len(new)] = new
        # ONE batched device encode over all affected stripes
        dchunks = span.reshape(n_str, self.k, si.chunk_size)
        parity = np.asarray(self.codec.encode_chunks_batch(dchunks))
        out: Dict[int, np.ndarray] = {}
        for j, idx in enumerate(range(first, last + 1)):
            chunks = np.concatenate([dchunks[j], parity[j]], axis=0)
            out[idx] = chunks
            self.cache.put(obj_key + (idx,), dchunks[j].copy())
        return out, max(old_size, offset + len(data))
