"""Reed-Solomon ``reed_sol_van`` over GF(2^8), bitsliced chunks.

The code: the systematic generator [I; P] with P = V_bot @ V_top^-1,
where V is the (k + m) x k Vandermonde matrix with rows
[1, i, i^2, ...] for the evaluation points i = 0 .. k+m-1 (0^0 = 1).

The layout: a chunk of U bytes is 8 plane regions of U/8 bytes; one
GF(2^8) symbol is bit-sliced across them (bit x of a symbol lies in
plane x; jerasure's schedule-encode packets).  A product by a GF(2^8)
matrix M is then the XOR of planes selected by M's bit-matrix, whose
row 8i+b, column 8j+x holds bit b of M[i, j] * 2^x.  XOR is bitwise,
so the planes may be handed over as bytes or as int32 words.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

POLY = 0x11D          # x^8 + x^4 + x^3 + x^2 + 1


def _mul_slow(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & 0x100:
            a ^= POLY
    return r


MUL = np.array([[_mul_slow(a, b) for b in range(256)] for a in range(256)],
               dtype=np.uint8)
INV = np.zeros(256, dtype=np.uint8)
for _a in range(1, 256):
    INV[_a] = int(np.flatnonzero(MUL[_a] == 1)[0])


def gf_pow(a: int, e: int) -> int:
    r = 1
    for _ in range(e):
        r = int(MUL[r, a])
    return r


def matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """A [r, n] @ B [n, c] over GF(2^8)."""
    A = np.asarray(A, dtype=np.uint8)
    B = np.asarray(B, dtype=np.uint8)
    out = np.zeros((A.shape[0], B.shape[1]), dtype=np.uint8)
    for i in range(A.shape[0]):
        for j in range(B.shape[1]):
            acc = 0
            for t in range(A.shape[1]):
                acc ^= int(MUL[A[i, t], B[t, j]])
            out[i, j] = acc
    return out


def inverse(M: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(2^8); raises ValueError if singular."""
    n = M.shape[0]
    a = np.concatenate([np.asarray(M, dtype=np.uint8),
                        np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        rows = [r for r in range(col, n) if a[r, col]]
        if not rows:
            raise ValueError("singular matrix")
        a[[col, rows[0]]] = a[[rows[0], col]]
        a[col] = MUL[INV[a[col, col]]][a[col]]
        for r in range(n):
            if r != col and a[r, col]:
                a[r] ^= MUL[a[r, col]][a[col]]
    return a[:, n:].copy()


def parity_matrix(k: int, m: int) -> np.ndarray:
    """P [m, k] of reed_sol_van."""
    V = np.array([[gf_pow(i, j) for j in range(k)] for i in range(k + m)],
                 dtype=np.uint8)
    return matmul(V[k:], inverse(V[:k]))


def generator(k: int, m: int) -> np.ndarray:
    return np.concatenate([np.eye(k, dtype=np.uint8), parity_matrix(k, m)])


def decode_matrix(k: int, m: int, avail: Sequence[int],
                  erased: Sequence[int]) -> np.ndarray:
    """D [len(erased), k] with chunk e = D[e] @ chunks[avail[:k]]."""
    G = generator(k, m)
    used = sorted(avail)[:k]
    return matmul(G[list(erased)], inverse(G[used]))


def bitmatrix(M: np.ndarray) -> np.ndarray:
    """[r, c] GF(2^8) matrix -> [8r, 8c] 0/1 bit-matrix."""
    r, c = M.shape
    out = np.zeros((8 * r, 8 * c), dtype=np.uint8)
    for i in range(r):
        for j in range(c):
            v = int(M[i, j])
            for x in range(8):
                for b in range(8):
                    out[8 * i + b, 8 * j + x] = (v >> b) & 1
                v = _mul_slow(v, 2)
    return out


def apply(M: np.ndarray, chunks: torch.Tensor) -> torch.Tensor:
    """chunks [B, c, L] (uint8 or int32, L divisible by 8) -> [B, r, L]:
    the product by M [r, c] in the bitsliced layout."""
    B, c, L = chunks.shape
    planes = chunks.reshape(B, 8 * c, L // 8)
    bm = bitmatrix(np.asarray(M))
    out = torch.zeros((B, bm.shape[0], L // 8), dtype=chunks.dtype,
                      device=chunks.device)
    for row in range(bm.shape[0]):
        for col in np.flatnonzero(bm[row]):
            out[:, row] ^= planes[:, int(col)]
    return out.reshape(B, M.shape[0], L)


def encode(k: int, m: int, data: torch.Tensor) -> torch.Tensor:
    """data chunks [B, k, L] -> parity chunks [B, m, L]."""
    return apply(parity_matrix(k, m), data)


def decode(k: int, m: int, avail: List[int], chunks: torch.Tensor,
           erased: List[int]) -> torch.Tensor:
    """chunks [B, len(avail), L] of the chunks ``avail`` -> the chunks
    ``erased`` [B, len(erased), L]."""
    used = sorted(avail)[:k]
    sel = torch.stack([chunks[:, list(avail).index(c)] for c in used], 1)
    return apply(decode_matrix(k, m, avail, erased), sel)
