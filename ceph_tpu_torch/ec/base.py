"""Shared codec scaffolding — the analog of the reference's ErasureCode base.

Provides the default single-stripe paths every matrix codec shares:
``encode_prepare`` pads the payload and splits it into aligned data chunks
(reference: src/erasure-code/ErasureCode.cc:151-186), default ``encode`` =
prepare + encode_chunks (ErasureCode.cc:188), default ``decode`` fills
erased chunk buffers then calls decode_chunks (ErasureCode.cc:206-242),
and chunk_index applies the logical→physical mapping (ErasureCode.cc:98).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set

import numpy as np

from .interface import (ErasureCodeError, ErasureCodeInterface,
                        ErasureCodeProfile, SubChunkPlan)

# Chunk payloads are padded to a multiple of this many bytes so device
# layouts stay lane-aligned (the reference uses SIMD_ALIGN=32 for AVX,
# ErasureCode.cc:42; TPU lanes want 128).
CHUNK_ALIGN = 128


class ErasureCodeBase(ErasureCodeInterface):
    k: int = 0
    m: int = 0

    def __init__(self) -> None:
        self._profile: ErasureCodeProfile = {}
        self.chunk_mapping: List[int] = []

    # ----------------------------------------------------------- profile --
    def get_profile(self) -> ErasureCodeProfile:
        return dict(self._profile)

    @staticmethod
    def profile_int(profile: ErasureCodeProfile, key: str, default: int,
                    *, minimum: int | None = None,
                    maximum: int | None = None) -> int:
        """Parse an integer profile entry with bounds (the to_int helper,
        ErasureCode.cc:251-281)."""
        raw = profile.get(key)
        if raw in (None, ""):
            return default
        try:
            v = int(str(raw), 0)
        except ValueError as e:
            raise ErasureCodeError(f"{key}={raw!r} is not an integer") from e
        if minimum is not None and v < minimum:
            raise ErasureCodeError(f"{key}={v} below minimum {minimum}")
        if maximum is not None and v > maximum:
            raise ErasureCodeError(f"{key}={v} above maximum {maximum}")
        return v

    # ---------------------------------------------------------- geometry --
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_chunk_size(self, stripe_width: int) -> int:
        align = CHUNK_ALIGN * self.k
        padded = -(-stripe_width // align) * align
        return padded // self.k

    def get_chunk_mapping(self) -> List[int]:
        return list(self.chunk_mapping)

    def chunk_index(self, i: int) -> int:
        return self.chunk_mapping[i] if self.chunk_mapping else i

    # ------------------------------------------------------ default paths --
    def encode_prepare(self, data: bytes | np.ndarray) -> np.ndarray:
        """Zero-pad to k*chunk_size and reshape to [k, chunk_size]."""
        buf = np.frombuffer(bytes(data), dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else \
            np.ascontiguousarray(data, dtype=np.uint8).ravel()
        chunk = self.get_chunk_size(len(buf))
        padded = np.zeros(self.k * chunk, dtype=np.uint8)
        padded[:len(buf)] = buf
        return padded.reshape(self.k, chunk)

    def encode(self, want_to_encode: Set[int],
               data: bytes | np.ndarray) -> Dict[int, np.ndarray]:
        chunks = self.encode_prepare(data)
        parity = self.encode_chunks(chunks)
        all_chunks = np.concatenate([chunks, parity], axis=0)
        return {i: all_chunks[self.chunk_index(i)] for i in want_to_encode}

    def minimum_to_decode(self, want_to_read: Set[int],
                          available: Set[int]) -> SubChunkPlan:
        """MDS default: any k available chunks suffice; prefer the wanted
        chunks themselves (ErasureCode.cc:62-96 semantics)."""
        if want_to_read <= available:
            return {c: [(0, self.get_sub_chunk_count())] for c in want_to_read}
        if len(available) < self.k:
            raise ErasureCodeError(
                f"need {self.k} chunks, only {len(available)} available")
        picked = sorted(want_to_read & available)
        for c in sorted(available - want_to_read):
            if len(picked) >= self.k:
                break
            picked.append(c)
        picked = sorted(picked)[:self.k]
        return {c: [(0, self.get_sub_chunk_count())] for c in picked}

    def decode(self, want_to_read: Set[int], chunks: Dict[int, np.ndarray],
               chunk_size: int) -> Dict[int, np.ndarray]:
        available = sorted(chunks)
        have = set(available)
        if want_to_read <= have:
            return {c: np.asarray(chunks[c], dtype=np.uint8)
                    for c in want_to_read}
        # sufficiency is codec-specific (layered codecs decode locally
        # from fewer than k chunks); decode_chunks raises if impossible.
        # Rebuild only what was asked for — a local read plan deliberately
        # leaves unrelated chunks unread.
        use = available[:self.k + self.m]
        erased = sorted(want_to_read - have)
        stack = np.stack([np.asarray(chunks[c], dtype=np.uint8)
                          for c in use])
        rebuilt = self.decode_chunks(use, stack, erased)
        out = {c: np.asarray(chunks[c], dtype=np.uint8)
               for c in want_to_read if c in have}
        for idx, c in enumerate(erased):
            if c in want_to_read:
                out[c] = rebuilt[idx]
        return out
