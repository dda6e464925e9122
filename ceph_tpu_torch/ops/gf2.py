"""Bit-sliced (packet/plane) GF(2) erasure-code layout — host/NumPy layer.

The byte-symbol codec path (ops/gf.py + ops/gf_jax.py) treats each byte
of a chunk as one GF(2^8) symbol and must therefore unpack bytes into
bit-planes around every device matmul — an 8x VPU expansion that caps
throughput.  jerasure's *bitmatrix* techniques (cauchy schedules,
liberation / blaum_roth / liber8tion — reference:
src/erasure-code/jerasure/ErasureCodeJerasure.h:174-240 and the
jerasure_schedule_encode call sites in ErasureCodeJerasure.cc:162,265)
sidestep exactly this on CPUs: each chunk is divided into w=8 equal
"packets" (planes), and one GF(2^8) codeword is formed by taking the
SAME bit position of the SAME byte offset across the 8 planes.  Under
that layout, multiplying by the GF(2) bit-matrix B [8m, 8k] is a pure
region-XOR program:

    out_plane[r] = XOR over { in_plane[c] : B[r, c] = 1 }

No bit unpacking ever happens — every bit lane of a 32-bit word is an
independent GF(2) codeword, so XOR on packed int32 words advances 32
codewords per ALU op.  This module is the NumPy oracle + layout algebra
for that path; the batched device kernel lives in ops/xor_kernel.py.

Layout notes (all pure reshapes, no data movement):
  chunk [L] bytes  ->  planes [8, L/8]   (plane p = bytes [pL/8, (p+1)L/8))
  k chunks [k, L]  ->  planes [8k, L/8]  (chunk-major: plane 8i+p)
The bit-matrix convention matches gf.gf8_bitmatrix: row/col 8i+b is bit
b of symbol i, so encode planes = gf8_bitmatrix(parity) and decode
planes = gf8_bitmatrix(decode_matrix) with NO new matrix machinery.

Equivalence to the byte-symbol path (validated by tests/test_gf2.py):
bit b of byte t of plane group i is bit b of GF symbol (i, t); the
region XOR computes exactly gf8_bitmatmul on the bit-transposed view.
"""
from __future__ import annotations

import numpy as np

from . import gf


# ----------------------------------------------------------------- layout --

def chunks_to_planes(chunks: np.ndarray) -> np.ndarray:
    """[..., n, L] uint8 -> [..., 8n, L//8] plane view (pure reshape).

    L must be divisible by 8 (get_chunk_size guarantees alignment).
    """
    a = np.asarray(chunks)
    n, L = a.shape[-2], a.shape[-1]
    if L % 8:
        raise ValueError(f"chunk length {L} not divisible by 8")
    return a.reshape(a.shape[:-2] + (8 * n, L // 8))


def planes_to_chunks(planes: np.ndarray) -> np.ndarray:
    """[..., 8n, P] -> [..., n, 8P] (inverse of chunks_to_planes)."""
    a = np.asarray(planes)
    n8, P = a.shape[-2], a.shape[-1]
    if n8 % 8:
        raise ValueError(f"plane count {n8} not divisible by 8")
    return a.reshape(a.shape[:-2] + (n8 // 8, 8 * P))


# ----------------------------------------------------------------- oracle --

def region_xor_matmul_np(bitmat: np.ndarray, planes: np.ndarray) -> np.ndarray:
    """out[..., r, :] = XOR_{c: bitmat[r,c]=1} planes[..., c, :].

    bitmat [R, C] 0/1 uint8; planes [..., C, P] uint8.  NumPy oracle for
    the device kernel; also the scalar reference for the native AVX2
    region codec.
    """
    bm = np.asarray(bitmat, dtype=np.uint8)
    pl = np.asarray(planes, dtype=np.uint8)
    R, C = bm.shape
    if pl.shape[-2] != C:
        raise ValueError(f"planes have {pl.shape[-2]} rows, bitmat wants {C}")
    out = np.zeros(pl.shape[:-2] + (R, pl.shape[-1]), dtype=np.uint8)
    for r in range(R):
        cols = np.flatnonzero(bm[r])
        if len(cols):
            acc = pl[..., cols[0], :].copy()
            for c in cols[1:]:
                acc ^= pl[..., c, :]
            out[..., r, :] = acc
    return out


def bitsliced_symbols(chunks: np.ndarray) -> np.ndarray:
    """Extract the GF(2^8) symbol array a bit-sliced chunk set encodes.

    [n, L] uint8 chunks -> [n, 8*(L//8)] uint8 symbols: symbol (i, 8t+b)
    has bit p equal to bit b of byte t of plane p of chunk i.  Test-only
    helper proving the layout equivalence (the inverse bit transpose).
    """
    pl = chunks_to_planes(chunks)           # [8n, P]
    n = chunks.shape[-2]
    P = pl.shape[-1]
    pl = pl.reshape(n, 8, P)
    # bit b of byte t of plane p -> bit p of symbol 8t+b
    bits = (pl[:, :, None, :] >> np.arange(8, dtype=np.uint8)[None, None, :,
                                                              None]) & 1
    # bits[i, p, b, t] -> symbol[i, t, b] bit p
    sym = np.zeros((n, P, 8), dtype=np.uint8)
    for p in range(8):
        sym |= (bits[:, p] << p).transpose(0, 2, 1)
    return sym.reshape(n, 8 * P)


# ------------------------------------------------------- GF(2) matrix ops --

def gf2_matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """(A @ B) mod 2 for 0/1 uint8 matrices."""
    return (np.asarray(A, dtype=np.int64) @
            np.asarray(B, dtype=np.int64) & 1).astype(np.uint8)


def gf2_inverse(M: np.ndarray) -> np.ndarray:
    """Invert a square 0/1 matrix over GF(2) (Gauss-Jordan).

    Raises ValueError if singular.  Decode-matrix construction for
    bitmatrix codes (jerasure_invert_bitmatrix role,
    src/erasure-code/jerasure/ErasureCodeJerasure.cc decode paths).
    """
    M = np.array(M, dtype=np.uint8) & 1
    n = M.shape[0]
    if M.shape != (n, n):
        raise ValueError("square matrix required")
    aug = np.concatenate([M, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = -1
        for r in range(col, n):
            if aug[r, col]:
                pivot = r
                break
        if pivot < 0:
            raise ValueError("singular matrix over GF(2)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        rows = np.flatnonzero(aug[:, col])
        rows = rows[rows != col]
        aug[rows] ^= aug[col]
    return aug[:, n:].copy()


def gf2_invertible(M: np.ndarray) -> bool:
    try:
        gf2_inverse(M)
        return True
    except ValueError:
        return False


def bitmatrix_masks(bitmat: np.ndarray) -> np.ndarray:
    """[R, C] 0/1 -> [R, C] int32 full-width masks (0 / -1) — the device
    operand layout of ops/xor_kernel.py (same orientation as the
    bit-matrix; the kernel takes static column slices)."""
    bm = np.asarray(bitmat, dtype=np.int32)
    return (-bm).astype(np.int32)
