"""Systematic GF(2^w) matrix codec — shared core of the RS/Cauchy plugins.

Encode is ``parity = P @ data`` over GF(2^w); decode inverts the k x k
sub-generator selected by the surviving chunks and multiplies once more.
This is the math both reference codec families reduce to (jerasure
jerasure_matrix_encode/decode, ISA-L ec_encode_data with precomputed
gftbls); the inverted matrices are LRU-cached per erasure signature like
the reference ISA table cache.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..ops import gf
from .base import ErasureCodeBase
from .interface import ErasureCodeError
from .table_cache import DecodeTableCache


class MatrixCodec(ErasureCodeBase):
    """Holds parity matrix P [m,k] over GF(2^w); w in {8, 16}."""

    def __init__(self) -> None:
        super().__init__()
        self.w = 8
        self.parity: np.ndarray | None = None
        from ..common.options import config
        self._cache = DecodeTableCache(
            capacity=int(config().get("ec_table_cache_size")))

    # -------------------------------------------------------------- setup --
    def set_matrix(self, parity: np.ndarray, w: int = 8) -> None:
        self.parity = np.asarray(
            parity, dtype=np.uint8 if w == 8 else np.uint16)
        self.m, self.k = self.parity.shape
        self.w = w

    def generator(self) -> np.ndarray:
        return gf.generator_matrix(self.parity)

    # ---------------------------------------------------------- data path --
    def _as_symbols(self, arr: np.ndarray) -> np.ndarray:
        """View uint8 chunk bytes as GF symbols (uint16 pairs for w=16)."""
        if self.w == 8:
            return arr
        if arr.shape[-1] % 2:
            raise ErasureCodeError("w=16 requires even chunk size")
        return np.ascontiguousarray(arr).view(np.uint16)

    @staticmethod
    def _as_bytes(arr: np.ndarray) -> np.ndarray:
        return arr if arr.dtype == np.uint8 else \
            np.ascontiguousarray(arr).view(np.uint8)

    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        data = np.asarray(data_chunks, dtype=np.uint8)
        if data.shape[0] != self.k:
            raise ErasureCodeError(
                f"expected {self.k} data chunks, got {data.shape[0]}")
        out = gf.gf_matmul(self.parity, self._as_symbols(data), self.w)
        return self._as_bytes(out)

    def decode_matrix(self, available_ids: Sequence[int],
                      erased_ids: Sequence[int]) -> Tuple[np.ndarray, list]:
        """[len(erased), k] recovery matrix R with erased = R @ avail[:k],
        plus the k available ids actually used.  Cached per signature."""
        avail = sorted(set(available_ids))[:self.k]
        if len(avail) < self.k:
            raise ErasureCodeError(
                f"need {self.k} chunks, have {len(set(available_ids))}")
        key = (tuple(avail), tuple(sorted(erased_ids)))
        hit = self._cache.get(key)
        if hit is not None:
            return hit, avail
        G = self.generator()
        try:
            inv = gf.gf_gaussian_inverse(G[avail], self.w)
        except ValueError as e:
            raise ErasureCodeError(
                f"singular sub-generator for chunks {avail}") from e
        R = gf.gf_matmul(G[sorted(erased_ids)], inv, self.w)
        self._cache.put(key, R)
        return R, avail

    def decode_chunks(self, available_ids: Sequence[int],
                      chunks: np.ndarray, erased_ids: Sequence[int]
                      ) -> np.ndarray:
        erased = sorted(erased_ids)
        if not erased:
            return np.zeros((0,) + tuple(chunks.shape[1:]), dtype=np.uint8)
        R, used = self.decode_matrix(available_ids, erased)
        order = list(available_ids)
        rows = np.stack([np.asarray(chunks[order.index(c)], dtype=np.uint8)
                         for c in used])
        out = gf.gf_matmul(R, self._as_symbols(rows), self.w)
        return self._as_bytes(out)
