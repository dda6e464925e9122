"""GF(2^8) linear algebra as PyTorch programs — the byte-layout EC math.

Port of ``ceph_tpu/ops/gf_jax.py`` (the module keeps the reference's name
so the layout mirrors it).  GF(2^8) multiplication by a constant is
GF(2)-linear in the operand bits, so a GF(2^8) matrix A [m,k] expands to a
GF(2) bit matrix B [8m,8k] and

    parity = pack( (B @ unpack(data)) mod 2 )

where unpack/pack move between byte rows and 0/1 bit-plane rows (bit b of
row i at row 8i+b, matching gf.bytes_to_bits).

``bitplane_matmul`` here is the PLAIN version of kernel K2: the unpack,
an ordinary matrix product and the repack, written in torch.  The product
runs in float32: every operand is 0 or 1 and every sum is at most
8k <= 2048, so each value is exact whatever the summation order, on the
CPU and on the card alike (so the card can hold K2 against it).  The
codec reaches it only for tensors on the CPU; on the card the codec
launches K2 (ops/gf_pallas.py).
"""
from __future__ import annotations

import collections
import functools
import threading

import numpy as np
import torch

from .. import resolve_device
from ..common.op_tracker import mark_active as _mark_active
from . import gf


def unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """[..., k, L] uint8 -> [..., 8k, L] uint8 of 0/1 (bit b of row i at
    row 8i+b, matching gf.bytes_to_bits)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = (data[..., :, None, :] >> shifts[:, None]) & 1
    s = bits.shape
    return bits.reshape(s[:-3] + (s[-3] * 8, s[-1]))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 8m, L] 0/1 -> [..., m, L] uint8."""
    s = bits.shape
    b = bits.reshape(s[:-2] + (s[-2] // 8, 8, s[-1])).to(torch.uint8)
    out = b[..., 0, :].clone()
    for i in range(1, 8):
        out |= b[..., i, :] << i
    return out


def bitplane_matmul(bitmat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matmul: bitmat [8m, 8k] 0/1 (from gf.gf8_bitmatrix), data
    [..., k, L] uint8 -> [..., m, L] uint8, batched over leading axes,
    on ``data``'s device.  The plain version of K2."""
    if data.dtype != torch.uint8:
        raise TypeError(f"data must be uint8, got {data.dtype}")
    bits = unpack_bits(data).to(torch.float32)
    acc = torch.matmul(bitmat.to(device=data.device, dtype=torch.float32),
                       bits)
    return pack_bits(acc.to(torch.int32) & 1)


_MATRIX_CACHE_SIZE = 4096


@functools.lru_cache(maxsize=_MATRIX_CACHE_SIZE)
def _bitmatrix_device(key: bytes, m: int, k: int,
                      device: str) -> torch.Tensor:
    mat = np.frombuffer(key, dtype=np.uint8).reshape(m, k)
    return torch.as_tensor(gf.gf8_bitmatrix(mat), device=device)


# content keys already materialized on a device: the per-call first-seen
# tag must come from THIS call's key, not the global lru miss counter
# (reading that before/after the call mis-tags ops when another thread's
# miss lands in between).  Same capacity and per-access recency update as
# the lru above, so eviction tracks it and a re-materialized matrix is
# tagged again.  Locked: OSD dispatcher threads hit this concurrently and
# the compound insert/move/evict is not atomic under the GIL.
_seen_matrices: collections.OrderedDict = collections.OrderedDict()
_seen_lock = threading.Lock()


def matrix_to_device(A: np.ndarray, device=None) -> torch.Tensor:
    """Host GF(2^8) matrix -> bit-matrix [8m, 8k] uint8 on ``device``
    (the package default when None), cached by content and device.

    A first-seen matrix means a NEW encode/decode matrix reached the
    device plane: a ``jit.compile`` child span and the ``jit.compiles``
    counters record its upload (there is no XLA compile in the port; the
    span keeps the reference's name so the same consumers read it)."""
    A = np.ascontiguousarray(A, dtype=np.uint8)
    dev = str(resolve_device(device))
    key = (A.tobytes(), A.shape, dev)
    with _seen_lock:
        first = key not in _seen_matrices
        _seen_matrices[key] = True
        _seen_matrices.move_to_end(key)
        while len(_seen_matrices) > _MATRIX_CACHE_SIZE:
            _seen_matrices.popitem(last=False)
    from ..common.jit_profile import compile_event, signature_of
    with compile_event("ec.gf_jax", signature_of(A), first):
        out = _bitmatrix_device(key[0], *A.shape, dev)
    _mark_active("dispatched_device", component="ec.gf_jax",
                 compiled=first)
    return out


def gf8_matmul(A: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """Host GF(2^8) matrix x uint8 tensor data through the plain version
    (on ``data``'s device)."""
    return bitplane_matmul(matrix_to_device(A, data.device), data)
