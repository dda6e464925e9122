"""Generic GF(2) bitmatrix codec over packet/plane chunk layout.

Port of ``ceph_tpu/ec/bitmatrix_codec.py``.  The codec space of
jerasure's schedule techniques: a [m*w, k*w] 0/1 parity bitmatrix acts on
chunks divided into w plane regions (ops/gf2.py layout).  Encode and
decode are masked region XOR:

  * the batched device path (``*_device``, and the ``*_batch`` methods
    that read its result back to the host): kernel K1,
    ``ops/xor_kernel.xor_matmul``, on a CUDA tensor, and its plain
    version on a CPU tensor;
  * the single-stripe host path (``encode_chunks`` / ``decode_chunks``):
    the native AVX2 region codec of ``native_bridge``.  A failed native
    build raises; there is no NumPy stand-in.

Decode matrices are GF(2) inversions of the surviving generator rows,
LRU-cached per erasure signature (the ISA table-cache role) and passed to
the kernel as a mask operand, so a new signature reuses the kernel.

Reference roles: jerasure_schedule_encode / jerasure_schedule_decode_lazy
(src/erasure-code/jerasure/ErasureCodeJerasure.cc:162,274),
jerasure bitmatrix decode construction (ErasureCodeJerasure.cc decode).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import native_bridge, resolve_device
from ..ops import gf2, xor_kernel
from .base import ErasureCodeBase
from .interface import ErasureCodeError
from .plugin_jax import _host
from .table_cache import DecodeTableCache


# batched encode / decode dispatches of every bitmatrix codec (each one
# trip through K1's wrapper): module counts, kept out of the perf
# registry, which the reference's bitmatrix codec does not write
encode_dispatches = 0
decode_dispatches = 0


class BitmatrixCodec(ErasureCodeBase):
    """Holds a parity bitmatrix B [m*w, k*w]; chunks carry w planes."""

    def __init__(self, device=None) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self.w = 8
        self.bitmatrix: np.ndarray | None = None
        from ..common.options import config
        self._cache = DecodeTableCache(
            capacity=int(config().get("ec_table_cache_size")))

    # -------------------------------------------------------------- setup --
    def set_bitmatrix(self, bm: np.ndarray, k: int, m: int, w: int) -> None:
        bm = np.asarray(bm, dtype=np.uint8) & 1
        if bm.shape != (m * w, k * w):
            raise ErasureCodeError(
                f"bitmatrix shape {bm.shape} != ({m * w}, {k * w})")
        self.bitmatrix = bm
        self.k, self.m, self.w = k, m, w

    def generator_bitmatrix(self) -> np.ndarray:
        """[(k+m)w, kw]: identity rows for data planes, then parity."""
        kw = self.k * self.w
        return np.concatenate(
            [np.eye(kw, dtype=np.uint8), self.bitmatrix], axis=0)

    def get_chunk_size(self, stripe_width: int) -> int:
        """Chunks must split into w planes whose byte count is 32-bit
        aligned for the packed-word kernels."""
        align = self.k * self.w * 4
        padded = -(-stripe_width // align) * align
        return padded // self.k

    # ---------------------------------------------------------- data path --
    def _check_chunk(self, L: int) -> None:
        if L % (self.w * 4):
            raise ErasureCodeError(
                f"chunk size {L} not divisible by {self.w * 4}")

    def _planes(self, chunks: np.ndarray, n: int) -> np.ndarray:
        a = np.asarray(chunks, dtype=np.uint8)
        L = a.shape[-1]
        self._check_chunk(L)
        return a.reshape(a.shape[:-2] + (n * self.w, L // self.w))

    def _chunks(self, planes: np.ndarray, L: int) -> np.ndarray:
        n = planes.shape[-2] // self.w
        return planes.reshape(planes.shape[:-2] + (n, L))

    @staticmethod
    def _combine_host(bitmat: np.ndarray,
                      planes: np.ndarray) -> np.ndarray:
        if planes.ndim == 2:
            return native_bridge.gf2_xor_regions(bitmat, planes)
        flat = planes.reshape((-1,) + planes.shape[-2:])
        out = native_bridge.gf2_xor_regions_batch(bitmat, flat)
        return out.reshape(planes.shape[:-2] + out.shape[-2:])

    def _tensor(self, x) -> torch.Tensor:
        """A tensor stays where it is; host data goes to the codec's
        device."""
        if isinstance(x, torch.Tensor):
            if x.dtype != torch.uint8:
                raise ErasureCodeError(f"expected torch.uint8, got {x.dtype}")
            return x
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.uint8),
                               device=self.device)

    def _plane_matmul(self, bitmat: np.ndarray,
                      chunks: torch.Tensor) -> torch.Tensor:
        """[..., n, L] uint8 chunks -> [..., rows/w, L] through K1 (its
        plain version on a CPU tensor): a reshape to [..., n*w, L/w]
        planes and back."""
        n, L = chunks.shape[-2], chunks.shape[-1]
        self._check_chunk(L)
        lead = tuple(chunks.shape[:-2])
        planes = chunks.reshape(lead + (n * self.w, L // self.w))
        out = xor_kernel.xor_matmul(
            xor_kernel.masks_to_device(bitmat, chunks.device), planes)
        return out.reshape(lead + (out.shape[-2] // self.w, L))

    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        data = np.asarray(data_chunks, dtype=np.uint8)
        if data.shape[-2] != self.k:
            raise ErasureCodeError(
                f"expected {self.k} data chunks, got {data.shape[-2]}")
        L = data.shape[-1]
        out = self._combine_host(self.bitmatrix, self._planes(data, self.k))
        return self._chunks(out, L)

    def encode_chunks_batch(self, data: np.ndarray) -> np.ndarray:
        return _host(self.encode_chunks_device(data))

    def encode_chunks_device(self, data) -> torch.Tensor:
        """Batched device path: [..., k, L] -> [..., m, L] uint8 on the
        data's device (NumPy data goes to the codec's device)."""
        d = self._tensor(data)
        if d.shape[-2] != self.k:
            raise ErasureCodeError(
                f"expected {self.k} data chunks, got {d.shape[-2]}")
        global encode_dispatches
        encode_dispatches += 1
        return self._plane_matmul(self.bitmatrix, d.contiguous())

    # -------------------------------------------------------------- decode --
    def decode_bitmatrix(self, available_ids: Sequence[int],
                         erased_ids: Sequence[int]
                         ) -> Tuple[np.ndarray, list]:
        """[e*w, k*w] GF(2) recovery bitmatrix R with
        erased_planes = R @ planes(avail_used), plus the used ids."""
        avail = sorted(set(available_ids))[:self.k]
        if len(avail) < self.k:
            raise ErasureCodeError(
                f"need {self.k} chunks, have {len(set(available_ids))}")
        key = (tuple(avail), tuple(sorted(erased_ids)))
        hit = self._cache.get(key)
        if hit is not None:
            return hit, avail
        G = self.generator_bitmatrix()
        w = self.w
        rows = np.concatenate(
            [np.arange(c * w, (c + 1) * w) for c in avail])
        try:
            inv = gf2.gf2_inverse(G[rows])
        except ValueError as e:
            raise ErasureCodeError(
                f"singular GF(2) sub-generator for chunks {avail}") from e
        er_rows = np.concatenate(
            [np.arange(c * w, (c + 1) * w) for c in sorted(erased_ids)])
        R = gf2.gf2_matmul(G[er_rows], inv)
        self._cache.put(key, R)
        return R, avail

    def decode_chunks(self, available_ids: Sequence[int],
                      chunks: np.ndarray, erased_ids: Sequence[int]
                      ) -> np.ndarray:
        erased = sorted(erased_ids)
        if not erased:
            return np.zeros((0,) + tuple(np.asarray(chunks).shape[1:]),
                            dtype=np.uint8)
        R, used = self.decode_bitmatrix(available_ids, erased)
        order = list(available_ids)
        rows = np.stack([np.asarray(chunks[order.index(c)], dtype=np.uint8)
                         for c in used])
        L = rows.shape[-1]
        out = self._combine_host(R, self._planes(rows, self.k))
        return self._chunks(out, L)

    def decode_chunks_batch(self, available_ids, chunks, erased_ids):
        return _host(self.decode_chunks_device(
            available_ids, chunks, erased_ids))

    def decode_chunks_device(self, available_ids, chunks,
                             erased_ids) -> torch.Tensor:
        """chunks [..., n_avail, L] for one erasure signature shared by
        the batch -> [..., n_erased, L] uint8 on the chunks' device; the
        recovery bitmatrix is a mask operand, so a new signature reuses
        the kernel."""
        dev = self._tensor(chunks)
        erased = sorted(erased_ids)
        if not erased:
            return torch.zeros(tuple(dev.shape[:-2]) + (0, dev.shape[-1]),
                               dtype=torch.uint8, device=dev.device)
        R, used = self.decode_bitmatrix(available_ids, erased)
        order = list(available_ids)
        sel = [order.index(c) for c in used]
        if sel != list(range(len(order))):
            dev = torch.stack([dev[..., i, :] for i in sel], dim=-2)
        global decode_dispatches
        decode_dispatches += 1
        return self._plane_matmul(R, dev.contiguous())
