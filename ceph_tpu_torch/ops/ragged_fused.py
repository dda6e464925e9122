"""Fused ragged GF(2^8) encode + per-block crc32 — one traversal.

Port of ``ceph_tpu/ops/ragged_fused.py``.  Mixed-size serving batches
(S3Serve's zipf object profile) are RAGGED: padding every object to the
batch max before the EC matmul moves and multiplies bytes that exist
only to squarify the rectangle.  This module stages a ragged batch as a
flat pool of fixed 4 KiB blocks plus row-offset/length DESCRIPTORS, so
the kernel's unit of work is a block that really exists, not a
rectangle row.

The fusion: one pass over each staged block computes its parity AND the
per-4 KiB crc sub-words of every data row and every parity row — the
parity rows' crcs straight from the parity before it is stored.  Those
sub-crcs are exactly the ``Csums`` the wire tier folds via
crc32_combine and BlueStore adopts as blob csums, so a fused encode
leaves nothing for the host to scan but sub-block tails.

Correctness shape: GF(2^8) matmul is LANE-WISE over byte positions, so
per-block staging with zero-padded tails yields parity bit-identical to
the padded-rectangle path after cropping (:func:`encode_padded`).
Device block crcs are used for FULL blocks only; a tail's crc is a host
scan of the valid prefix (counted at ``device_tail``, same convention
as crc32_gf2.csums_many).

Dispatch (``_dispatch``): with the sharded data plane on (``impl``
``auto`` or ``plane``), the pool splits over the plane's cells
(parallel/data_plane.fused_ragged), each cell running K3 or its plain
version by its device; otherwise it goes by the pool's device: a CUDA
pool launches kernel K3 (ops/gf_pallas.fused_ragged_matmul,
csrc/ragged_fused.cu), a CPU pool runs the plain version
:func:`fused_block_math`.  Unlike the reference, ``impl="pallas"`` on a
CPU pool raises instead of running the plain version.
"""
from __future__ import annotations

import zlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..common import crcutil
from . import crc32_gf2, gf

TILE = crcutil.CSUM_BLOCK        # 4096: crc sub-word == staging block


class RaggedBatch:
    """A packed ragged batch: ``pool`` [G, k, TILE] uint8 (zero-padded
    tails) plus per-block descriptors ``desc`` [G, 2] int32 of
    (object index, valid byte count) — an object's blocks are
    contiguous in pool order, so the descriptor table is the whole
    page-table analogy: the kernel sees dense blocks, the unpack walks
    the table."""

    __slots__ = ("pool", "desc", "lengths", "k", "tile")

    def __init__(self, pool: np.ndarray, desc: np.ndarray,
                 lengths: List[int], k: int, tile: int):
        self.pool = pool
        self.desc = desc
        self.lengths = lengths
        self.k = k
        self.tile = tile

    def rect_bytes(self, m: int) -> int:
        """Bytes the padded-rectangle path moves for this batch:
        every object padded to the batch max, k data + m parity."""
        if not self.lengths:
            return 0
        return len(self.lengths) * (self.k + m) * max(self.lengths)

    def fused_bytes(self, m: int) -> int:
        """Bytes the fused path moves: only blocks that exist."""
        return int(self.pool.shape[0]) * (self.k + m) * self.tile

    def padding_avoided(self, m: int) -> int:
        """The headline delta: rectangle padding the descriptor
        layout never stages (>= 0 by construction — a block pool pads
        each object to a TILE multiple, never to the batch max)."""
        return max(0, self.rect_bytes(m) - self.fused_bytes(m))


def pack(shards: Sequence[np.ndarray], tile: int = TILE) -> RaggedBatch:
    """Stage ragged shard groups into the block pool.  ``shards`` is a
    sequence of [k, L_i] uint8 arrays with a common k and ragged L_i
    (>= 1 — even a 1-byte object owns one zero-padded block, because
    its parity still has to come out of the matmul)."""
    if not shards:
        raise ValueError("empty ragged batch")
    k = int(shards[0].shape[0])
    lengths: List[int] = []
    blocks: List[np.ndarray] = []
    desc: List[Tuple[int, int]] = []
    for i, s in enumerate(shards):
        a = np.ascontiguousarray(s, dtype=np.uint8)
        if a.ndim != 2 or a.shape[0] != k:
            raise ValueError(f"shard group {i}: want [k={k}, L] rows")
        L = int(a.shape[1])
        if L <= 0:
            raise ValueError(f"shard group {i}: empty object")
        lengths.append(L)
        n_blk = -(-L // tile)
        pad = n_blk * tile - L
        if pad:
            a = np.pad(a, ((0, 0), (0, pad)))
        for b in range(n_blk):
            blocks.append(a[:, b * tile:(b + 1) * tile])
            desc.append((i, min(tile, L - b * tile)))
    pool = np.stack(blocks, axis=0)
    return RaggedBatch(pool, np.asarray(desc, dtype=np.int32),
                       lengths, k, tile)


class RaggedResult:
    """Per-object outputs of one fused (or comparator) encode:
    ``parity[i]`` [m, L_i] uint8; ``data_csums[i]`` / ``parity_csums[i]``
    are the k (resp. m) per-row :class:`crcutil.Csums` — the trusted
    sub-crcs the wire/store tiers consume without rescanning."""

    __slots__ = ("parity", "data_csums", "parity_csums")

    def __init__(self, parity, data_csums, parity_csums):
        self.parity = parity
        self.data_csums = data_csums
        self.parity_csums = parity_csums


def _crc_a8(tile: int) -> Tuple[np.ndarray, int]:
    """crc32_gf2.crc_matrix reshaped for per-bit-plane contraction:
    A8 [8, tile, 32] int8 with A8[b, t] = A[8t+b]."""
    A, const = crc32_gf2.crc_matrix(tile)
    A8 = np.ascontiguousarray(
        A.reshape(tile, 8, 32).transpose(1, 0, 2).astype(np.int8))
    return A8, const


def fused_block_math(bitmat: torch.Tensor, crcA8: torch.Tensor, const: int,
                     pool: torch.Tensor):
    """The plain version of K3, in torch on ``pool``'s device: pool
    [G, k, T] uint8 -> (parity [G, m, T] uint8, data block crcs [G, k]
    int64, parity block crcs [G, m] int64; each crc a uint32 value).

    One bit-unpack feeds BOTH contractions, and the parity crcs are
    contracted from the parity BIT planes before packing.  The products
    run in float32: every operand is 0 or 1 and every sum is at most
    8 * max(k, T) < 2^24, so each value is exact in any summation
    order.  It unpacks 32x: callers run it in chunks."""
    G, k, T = pool.shape
    dev = pool.device
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    bits = (pool[..., None, :] >> shifts[:, None]) & 1     # [G, k, 8, T]
    # GF(2^8) leg: bit b of symbol row j at plane row 8j+b
    gf_bits = bits.reshape(G, 8 * k, T).to(torch.float32)
    acc = torch.matmul(bitmat.to(dev, torch.float32), gf_bits)
    m = acc.shape[1] // 8
    pbits = (acc.to(torch.int32) & 1).to(torch.uint8).reshape(G, m, 8, T)
    parity = pbits[:, :, 0].clone()
    for b in range(1, 8):
        parity |= pbits[:, :, b] << b
    # crc leg: contract each row's bit planes against A8 — data rows from
    # the staged bits, parity rows from the matmul's own bit planes
    A = crcA8.to(dev, torch.float32).reshape(8 * T, 32)
    dacc = torch.matmul(gf_bits.reshape(G * k, 8 * T), A)
    pacc = torch.matmul(pbits.reshape(G * m, 8 * T).to(torch.float32), A)
    weights = torch.ones(32, dtype=torch.int64, device=dev) << \
        torch.arange(32, dtype=torch.int64, device=dev)
    dcrc = ((dacc.to(torch.int64) & 1) * weights).sum(-1) ^ const
    pcrc = ((pacc.to(torch.int64) & 1) * weights).sum(-1) ^ const
    return parity, dcrc.reshape(G, k), pcrc.reshape(G, m)


def _dispatch(bitmat_np: np.ndarray, pool: torch.Tensor,
              impl: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Route one pool: over the data plane's cells when it is on, else
    K3 for a CUDA pool and the plain version for a CPU pool (through
    gf_pallas.fused_ragged_matmul, which dispatches by device).  ``impl``
    names what the caller asks for: ``auto`` any of them, ``plane`` the
    data plane when it is on (else as ``auto``), ``pallas`` the kernel
    (a CPU pool raises), ``xla`` the plain version (a CUDA pool
    raises)."""
    from ..parallel import data_plane
    from . import gf_pallas
    if impl not in ("auto", "plane", "pallas", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    pl = data_plane.plane() if impl in ("auto", "plane") else None
    if pl is not None:
        parity, dcrc, pcrc = pl.fused_ragged(bitmat_np, pool,
                                             int(pool.shape[2]))
        return (parity.cpu().numpy(), dcrc.cpu().numpy().astype(np.uint32),
                pcrc.cpu().numpy().astype(np.uint32))
    if impl == "pallas" and pool.device.type != "cuda":
        raise ValueError(f"impl='pallas' asks for kernel K3, which runs on "
                         f"a CUDA pool; this pool is on {pool.device}")
    if impl == "xla" and pool.device.type != "cpu":
        raise ValueError(f"impl='xla' asks for the plain version, which "
                         f"runs on a CPU pool only; this pool is on "
                         f"{pool.device}")
    parity, dcrc, pcrc = gf_pallas.fused_ragged_matmul(bitmat_np, pool)
    return (parity.cpu().numpy(), dcrc.cpu().numpy().astype(np.uint32),
            pcrc.cpu().numpy().astype(np.uint32))


def encode(A: np.ndarray, shards: Sequence[np.ndarray],
           impl: str = "auto", device=None) -> RaggedResult:
    """Fused ragged encode: parity AND trusted per-4 KiB sub-crcs for
    every data/parity row of every ragged object, one traversal.

    ``A`` [m, k] GF(2^8) parity matrix; ``shards[i]`` [k, L_i] uint8,
    host in and host out; the pool is staged on ``device`` (the package
    default when None).  Device crcs cover FULL blocks; tail prefixes
    are host-scanned (counted, ``device_tail``).  The padding win is
    :meth:`RaggedBatch.padding_avoided`."""
    A = np.ascontiguousarray(A, dtype=np.uint8)
    m = int(A.shape[0])
    batch = pack(shards)
    bitmat = gf.gf8_bitmatrix(A)
    pool = torch.from_numpy(batch.pool).to(resolve_device(device))
    parity_pool, dcrc, pcrc = _dispatch(bitmat, pool, impl)
    tile = batch.tile
    # unpack the descriptor table back into per-object rows
    parities: List[np.ndarray] = []
    data_csums: List[List[crcutil.Csums]] = []
    parity_csums: List[List[crcutil.Csums]] = []
    g = 0
    for i, L in enumerate(batch.lengths):
        n_blk = -(-L // tile)
        blocks = slice(g, g + n_blk)
        par = parity_pool[blocks].transpose(1, 0, 2).reshape(
            m, n_blk * tile)[:, :L]
        parities.append(np.ascontiguousarray(par))
        n_full = L // tile
        tail = L - n_full * tile
        drows: List[crcutil.Csums] = []
        for j in range(batch.k):
            subs = [int(c) for c in dcrc[g:g + n_full, j]]
            if tail:
                subs.append(zlib.crc32(
                    shards[i][j, n_full * tile:L].tobytes()))
                crcutil.note_scan(tail, "device_tail")
            drows.append(crcutil.Csums(tile, subs, L))
        data_csums.append(drows)
        prows: List[crcutil.Csums] = []
        for j in range(m):
            subs = [int(c) for c in pcrc[g:g + n_full, j]]
            if tail:
                subs.append(zlib.crc32(par[j, n_full * tile:].tobytes()))
                crcutil.note_scan(tail, "device_tail")
            prows.append(crcutil.Csums(tile, subs, L))
        parity_csums.append(prows)
        g += n_blk
    return RaggedResult(parities, data_csums, parity_csums)


def encode_padded(A: np.ndarray, shards: Sequence[np.ndarray],
                  device=None) -> RaggedResult:
    """The unfused padded-rectangle comparator (and bit-identity
    oracle of record): pad every object to the batch max, run the
    plain gf_jax bit-plane product on ``device`` (the package default
    when None), then pay the SEPARATE host crc scan over every data and
    parity row (counted at ``unfused`` — exactly the double traversal
    the fused path deletes)."""
    from . import gf_jax
    A = np.ascontiguousarray(A, dtype=np.uint8)
    m = int(A.shape[0])
    lens = [int(s.shape[1]) for s in shards]
    Lmax = max(lens)
    k = int(shards[0].shape[0])
    rect = np.zeros((len(shards), k, Lmax), dtype=np.uint8)
    for i, s in enumerate(shards):
        rect[i, :, :lens[i]] = s
    dev = resolve_device(device)
    out = gf_jax.bitplane_matmul(
        torch.from_numpy(gf.gf8_bitmatrix(A)).to(dev),
        torch.from_numpy(rect).to(dev)).cpu().numpy()
    parities = [np.ascontiguousarray(out[i][:, :lens[i]])
                for i in range(len(shards))]
    data_csums = [[crcutil.Csums.scan(np.ascontiguousarray(s[j]),
                                      block=TILE, site="unfused")
                   for j in range(k)] for s in shards]
    parity_csums = [[crcutil.Csums.scan(p[j], block=TILE,
                                        site="unfused")
                     for j in range(m)] for p in parities]
    return RaggedResult(parities, data_csums, parity_csums)
