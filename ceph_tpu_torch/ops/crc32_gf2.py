"""Batched CRC32 over fixed-size blocks — the device crc of the wire tier.

Port of ``ceph_tpu/ops/crc32_gf2.py``.  CRC32 over a fixed-length block
is an AFFINE map over GF(2): for a block of B bytes viewed as a bit
vector m in GF(2)^(8B),

    crc(m) = A @ m  ^  c        (A: 32 x 8B over GF(2), c = crc(0^B))

The matrix is built from the crc's own algebra, not 8B brute-force
scans: column (p, b) — bit b of byte p — equals Z^(B-1-p) @ L0[b],
where L0[b] is the linear crc of the single byte (1<<b) and Z is the
advance-one-zero-byte operator (common/crcutil's combine matrix), so
construction is an O(B) table walk.

``crc32_blocks`` dispatches by the tensor's device:

  * CUDA: kernel K3's crc leg alone (``gf_pallas.crc_leg``: m = 0, the
    blocks viewed as an [N, 1, B] pool), one launch for the whole batch.
    The reference's XLA program is a GF(2) matmul; on the card the crc
    is a table walk split over a block's 256 threads, 16 bytes each,
    which uses the same algebra (csrc/ragged_fused.cu).
  * CPU: the plain version ``crc32_blocks_plain`` — unpack to 0/1 and one
    float32 product with A.  Every sum is at most 8B, exact below 2^24.
    It unpacks 32x, so it is the tests' and the card's oracle, never the
    card's engine.

``device_worthwhile`` says whether ``wire_device_crc=auto`` engages: when
the package default device is CUDA.  The NumPy oracle
:func:`crc32_blocks_np` validates both bit-for-bit.
"""
from __future__ import annotations

import warnings
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import default_device, resolve_device
from ..common import crcutil

_M32 = 0xFFFFFFFF

# block -> (A [8B, 32] uint8, affine const crc(0^B))
_matrix_cache: Dict[int, Tuple[np.ndarray, int]] = {}

plain_runs = 0


def crc_matrix(block: int) -> Tuple[np.ndarray, int]:
    """The affine map of crc32 over ``block``-byte messages:
    (A [8*block, 32] uint8 over GF(2), c = crc32 of the zero block).
    Row 8p+b of A is the crc image of bit b of byte p."""
    hit = _matrix_cache.get(block)
    if hit is not None:
        return hit
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    z0 = zlib.crc32(b"\x00")
    base = [zlib.crc32(bytes([1 << b])) ^ z0 for b in range(8)]
    z1 = crcutil._zero_op(1)           # advance one zero byte

    def _adv(v: int) -> int:
        return (z1[0][v & 0xFF] ^ z1[1][(v >> 8) & 0xFF] ^
                z1[2][(v >> 16) & 0xFF] ^ z1[3][v >> 24])

    cols = np.zeros((8 * block,), dtype=np.uint32)
    cur = list(base)
    for p in range(block - 1, -1, -1):
        for b in range(8):
            cols[8 * p + b] = cur[b]
        cur = [_adv(v) for v in cur]
    # unpack each column's 32 output bits -> [8B, 32] uint8
    bits = ((cols[:, None] >> np.arange(32, dtype=np.uint32)[None, :])
            & 1).astype(np.uint8)
    const = zlib.crc32(b"\x00" * block)
    _matrix_cache[block] = (bits, const)
    return bits, const


def _block_bits_np(blocks: np.ndarray) -> np.ndarray:
    """[N, B] uint8 -> [N, 8B] bit planes, bit b of byte p at 8p+b
    (matching crc_matrix's row order)."""
    a = np.ascontiguousarray(blocks, dtype=np.uint8)
    return np.unpackbits(a, axis=-1, bitorder="little")


def crc32_blocks_np(blocks: np.ndarray) -> np.ndarray:
    """NumPy oracle: crc32 of each row of ``blocks`` [N, B] uint8."""
    a = np.ascontiguousarray(blocks, dtype=np.uint8)
    if a.ndim != 2:
        raise ValueError("blocks must be [N, B]")
    A, const = crc_matrix(a.shape[1])
    bits = _block_bits_np(a).astype(np.int64)
    out_bits = (bits @ A.astype(np.int64)) & 1
    vals = (out_bits.astype(np.uint64)
            << np.arange(32, dtype=np.uint64)[None, :]).sum(
                axis=1).astype(np.uint32)
    return vals ^ np.uint32(const)


# -------------------------------------------------------------- device ---

def crc32_blocks_plain(blocks: torch.Tensor) -> torch.Tensor:
    """The plain version: [N, B] uint8 -> [N] int64 crc32 values, on
    ``blocks``' device (unpack, one float32 product with A, repack)."""
    N, B = blocks.shape
    if 8 * B >= 1 << 24:
        raise ValueError(f"block {B}: the float32 product is exact only "
                         f"below 2^21-byte blocks")
    A, const = crc_matrix(B)
    shifts = torch.arange(8, dtype=torch.uint8, device=blocks.device)
    bits = ((blocks[..., None] >> shifts) & 1).reshape(N, 8 * B)
    acc = torch.matmul(bits.to(torch.float32),
                       torch.from_numpy(A).to(blocks.device, torch.float32))
    weights = torch.ones(32, dtype=torch.int64, device=blocks.device) << \
        torch.arange(32, dtype=torch.int64, device=blocks.device)
    vals = ((acc.to(torch.int64) & 1) * weights).sum(-1)
    return vals ^ const


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host array as a tensor without a copy.  Receive buffers may be
    read-only; the tensor is only read, so torch's warning about that
    is moot."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


def crc32_blocks(blocks, block: int = crcutil.CSUM_BLOCK,
                 device=None) -> np.ndarray:
    """crc32 of every row of ``blocks`` ([N, block] uint8: a tensor, or a
    host array moved to ``device``, the package default when None) as
    uint32: ONE dispatch for the whole batch — K3's crc leg on a CUDA
    tensor, the plain version on a CPU tensor."""
    global plain_runs
    if isinstance(blocks, torch.Tensor):
        arr = blocks
    else:
        arr = _host_tensor(np.ascontiguousarray(blocks, dtype=np.uint8)) \
            .to(resolve_device(device))
    if arr.dtype != torch.uint8:
        raise TypeError(f"blocks must be uint8, got {arr.dtype}")
    if arr.dim() != 2 or arr.shape[1] != block:
        raise ValueError(f"blocks must be [N, {block}]")
    if arr.device.type == "cuda":
        from . import gf_pallas
        out = gf_pallas.crc_leg(arr.contiguous())
    elif arr.device.type == "cpu":
        plain_runs += 1
        out = crc32_blocks_plain(arr)
    else:
        raise ValueError(f"no crc kernel for device {arr.device}")
    vals = out.cpu().numpy().astype(np.uint32)
    _counters_inc(int(arr.shape[0]) * block)
    return vals


def device_worthwhile() -> bool:
    """True when the package default device is CUDA: the kernel beats a
    host zlib scan there; the CPU plain version does not
    (``wire_device_crc`` option: auto/on/off)."""
    return torch.device(default_device()).type == "cuda"


def _counters_inc(nbytes: int) -> None:
    from ..common.perf_counters import perf
    pc = perf("wire.zero")
    pc.inc("device_crc_dispatches")
    pc.inc("device_crc_bytes", int(nbytes))


def csums_for(buf, block: int = crcutil.CSUM_BLOCK) -> crcutil.Csums:
    """One buffer's Csums with the full blocks crc'd ON DEVICE (one
    dispatch) and only the sub-block tail scanned by the host — zero
    host passes over the aligned payload body."""
    return csums_many([buf], block=block)[0]


def csums_many(bufs: Sequence, block: int = crcutil.CSUM_BLOCK
               ) -> List[crcutil.Csums]:
    """Batched Csums for many buffers: every full block across every
    buffer rides ONE device dispatch; tails (len % block) are host
    scanned (counted at ``device_tail``, negligible)."""
    views = [crcutil.as_u8(np.ascontiguousarray(buf)
                           if isinstance(buf, np.ndarray) else buf)
             for buf in bufs]
    stacked: List[np.ndarray] = []
    spans: List[Tuple[int, int]] = []     # (first_row, n_rows) per buf
    row = 0
    for mv in views:
        n_full = len(mv) // block
        if n_full:
            stacked.append(np.frombuffer(
                mv[:n_full * block], dtype=np.uint8).reshape(
                    n_full, block))
        spans.append((row, n_full))
        row += n_full
    full_crcs = (crc32_blocks(np.concatenate(stacked, axis=0), block)
                 if stacked else np.zeros((0,), dtype=np.uint32))
    out: List[crcutil.Csums] = []
    for mv, (first, n_full) in zip(views, spans):
        subs = [int(c) for c in full_crcs[first:first + n_full]]
        tail = mv[n_full * block:]
        if len(tail):
            subs.append(zlib.crc32(tail))
            crcutil.note_scan(len(tail), "device_tail")
        out.append(crcutil.Csums(block, subs, len(mv)))
    return out
