"""The erasure-code codec contract.

Re-expresses the reference's abstract codec interface
(src/erasure-code/ErasureCodeInterface.h:170-467) for an array-native
runtime: chunk payloads are NumPy uint8 arrays (host) or JAX arrays
(device), and every data-path method also has a batched form so the TPU
backend can amortize dispatch over many stripes — the capability the
reference approximates with thread pools.

Terminology (matches the reference):
  * k data chunks, m coding chunks; chunk ids 0..k+m-1.
  * ``minimum_to_decode(want, available)`` returns, per needed chunk, the
    sub-chunk index ranges to read (ErasureCodeInterface.h:297; the
    sub-chunk granularity exists for CLAY, h:259).
  * ``get_chunk_mapping`` permutes logical→physical chunk order
    (ErasureCodeInterface.h:448).
"""
from __future__ import annotations

import abc
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

# profile: string key/value map, as stored in the cluster map and validated
# by instantiating the plugin (reference: src/mon/OSDMonitor.cc:7349-7444)
ErasureCodeProfile = Dict[str, str]

# per-chunk list of (offset, count) sub-chunk ranges
SubChunkPlan = Dict[int, List[Tuple[int, int]]]


class ErasureCodeError(Exception):
    """Codec-level failure (bad profile, insufficient chunks, ...)."""


class ErasureCodeInterface(abc.ABC):
    """Abstract codec; concrete plugins register in the plugin registry."""

    # ------------------------------------------------------------ profile --
    @abc.abstractmethod
    def init(self, profile: ErasureCodeProfile) -> None:
        """Parse/validate profile and precompute matrices.  Raises
        ErasureCodeError on invalid profiles (the mon-side validation
        path relies on this)."""

    @abc.abstractmethod
    def get_profile(self) -> ErasureCodeProfile:
        ...

    # ----------------------------------------------------------- geometry --
    @abc.abstractmethod
    def get_chunk_count(self) -> int:
        """k + m."""

    @abc.abstractmethod
    def get_data_chunk_count(self) -> int:
        """k."""

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        """Sub-chunks per chunk (1 unless CLAY-style regenerating code)."""
        return 1

    @abc.abstractmethod
    def get_chunk_size(self, stripe_width: int) -> int:
        """Bytes per chunk for an object of ``stripe_width`` bytes
        (includes padding/alignment)."""

    def get_chunk_mapping(self) -> List[int]:
        """chunk_mapping[logical] = physical position; empty = identity."""
        return []

    # ------------------------------------------------------- decode plans --
    @abc.abstractmethod
    def minimum_to_decode(self, want_to_read: Set[int],
                          available: Set[int]) -> SubChunkPlan:
        """Cheapest read plan covering ``want_to_read`` given ``available``
        chunks, as {chunk_id: [(sub_offset, sub_count), ...]}."""

    def minimum_to_decode_with_cost(self, want_to_read: Set[int],
                                    available: Dict[int, int]) -> Set[int]:
        """Pick chunks minimizing total retrieval cost
        (ErasureCodeInterface.h:326). Default: cheapest-first greedy."""
        by_cost = sorted(available, key=lambda c: (available[c], c))
        chosen: Set[int] = set()
        for c in by_cost:
            chosen.add(c)
            try:
                return set(self.minimum_to_decode(want_to_read, chosen))
            except ErasureCodeError:
                continue
        raise ErasureCodeError("insufficient chunks to decode")

    # -------------------------------------------------------- single path --
    @abc.abstractmethod
    def encode(self, want_to_encode: Set[int],
               data: bytes | np.ndarray) -> Dict[int, np.ndarray]:
        """Pad+split ``data`` into k chunks, compute m parities, return the
        requested chunk payloads (ErasureCodeInterface.h:370 semantics)."""

    @abc.abstractmethod
    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        """[k, chunk_size] -> [m, chunk_size] parity."""

    @abc.abstractmethod
    def decode(self, want_to_read: Set[int], chunks: Dict[int, np.ndarray],
               chunk_size: int) -> Dict[int, np.ndarray]:
        """Reconstruct ``want_to_read`` chunk payloads from any sufficient
        subset (ErasureCodeInterface.h:411 semantics)."""

    @abc.abstractmethod
    def decode_chunks(self, available_ids: Sequence[int],
                      chunks: np.ndarray, erased_ids: Sequence[int]
                      ) -> np.ndarray:
        """chunks[len(available_ids), chunk_size] -> erased payloads
        [len(erased_ids), chunk_size]."""

    def decode_concat(self, chunks: Dict[int, np.ndarray]) -> np.ndarray:
        """Reconstruct and concatenate the k data chunks in order
        (ErasureCodeInterface.h:461)."""
        want = set(range(self.get_data_chunk_count()))
        size = len(next(iter(chunks.values())))
        dec = self.decode(want, chunks, size)
        return np.concatenate(
            [dec[i] for i in range(self.get_data_chunk_count())])

    # ------------------------------------------------------- batched path --
    # TPU-native extension: same contracts, leading stripe axis.  Default
    # implementations loop; the jax plugin overrides with one jitted call.

    def encode_chunks_batch(self, data: np.ndarray) -> np.ndarray:
        """[B, k, chunk] -> [B, m, chunk]."""
        return np.stack([self.encode_chunks(d) for d in data])

    def decode_chunks_batch(self, available_ids: Sequence[int],
                            chunks: np.ndarray, erased_ids: Sequence[int]
                            ) -> np.ndarray:
        """[B, len(available), chunk] -> [B, len(erased), chunk], one shared
        erasure signature for the whole batch."""
        return np.stack(
            [self.decode_chunks(available_ids, c, erased_ids)
             for c in chunks])
