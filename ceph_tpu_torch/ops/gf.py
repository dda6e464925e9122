"""Galois-field arithmetic for erasure coding — the host/NumPy reference layer.

The reference delegates GF math to the jerasure/gf-complete and ISA-L
libraries (empty submodules in this checkout — see SURVEY.md), so this module
re-derives the arithmetic from first principles:

  * GF(2^8)  — field tables for the AES-adjacent polynomial 0x11d used by both
    gf-complete (w=8) and ISA-L; all data-path codecs run in this field.
  * GF(2^16) — tables for polynomial 0x1100b (gf-complete w=16 default), used
    by wide reed_sol_van profiles (reference:
    src/erasure-code/jerasure/ErasureCodeJerasure.cc:450-474).
  * generic carry-less multiply for w=32 (poly 0x100400007) — matrix
    generation only.

Matrix machinery: GF matmul, Gaussian inversion, systematic Vandermonde
generator construction (semantics of jerasure's reed_sol_van coding matrix —
the systematic form of a Vandermonde code is unique, so building
``P = V_bot @ inv(V_top)`` reproduces the reference matrix without porting
its elementary-operation sequence), Cauchy constructions (jerasure
cauchy_orig/cauchy_good and ISA-L gf_gen_cauchy1 variants), and the
bit-matrix expansion that turns a GF(2^8) matrix into a GF(2) matrix of
8x8 blocks — the formulation the TPU kernel multiplies on the MXU
(see ceph_tpu/ec/gf_jax.py).

Everything here is NumPy on host: it is the correctness oracle and the
matrix-preparation path; the batched data path lives in the JAX plugin.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

# Primitive polynomials (with the x^w term), per gf-complete defaults.
POLY8 = 0x11D
POLY16 = 0x1100B
POLY32 = 0x100400007


# ------------------------------------------------------------------ tables --

@functools.lru_cache(maxsize=None)
def _tables(w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(exp, log) tables for GF(2^w), generator alpha=2."""
    if w == 8:
        poly, n = POLY8, 1 << 8
    elif w == 16:
        poly, n = POLY16, 1 << 16
    else:
        raise ValueError(f"no tables for w={w}")
    exp = np.zeros(2 * n, dtype=np.int64)
    log = np.zeros(n, dtype=np.int64)
    x = 1
    for i in range(n - 1):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & n:
            x ^= poly
    # duplicate so exp[(la+lb)] never needs a mod
    exp[n - 1:2 * (n - 1)] = exp[:n - 1]
    exp.setflags(write=False)
    log.setflags(write=False)
    return exp, log


def gf_mul(a, b, w: int = 8):
    """Element-wise GF(2^w) multiply (NumPy-broadcasting)."""
    exp, log = _tables(w)
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    out = exp[log[a] + log[b]]
    return np.where((a == 0) | (b == 0), 0, out)


def gf_inv(a, w: int = 8):
    exp, log = _tables(w)
    a = np.asarray(a, dtype=np.int64)
    if np.any(a == 0):
        raise ZeroDivisionError("gf_inv(0)")
    order = (1 << w) - 1
    return exp[(order - log[a]) % order]


def gf_div(a, b, w: int = 8):
    b_inv = gf_inv(b, w)
    return gf_mul(a, b_inv, w)


def gf_pow(a: int, e: int, w: int = 8) -> int:
    """Scalar power; gf_pow(0, 0) == 1 by Vandermonde convention."""
    if e == 0:
        return 1
    if a == 0:
        return 0
    exp, log = _tables(w)
    order = (1 << w) - 1
    return int(exp[(int(log[a]) * e) % order])


def gf_mul_slow(a: int, b: int, w: int, poly: int) -> int:
    """Carry-less multiply + reduce — any width (used for w=32)."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & (1 << w):
            a ^= poly
    return r


# ------------------------------------------------------------------ matmul --

def gf_matmul(A: np.ndarray, B: np.ndarray, w: int = 8) -> np.ndarray:
    """C = A @ B over GF(2^w); A is [m,k], B is [k,...] (uint arrays).

    Log-table formulation: products become exp[log a + log b]; the GF sum is
    XOR-reduce over the contraction axis.
    """
    exp, log = _tables(w)
    A = np.asarray(A, dtype=np.int64)
    B = np.asarray(B, dtype=np.int64)
    la = log[A]                                   # [m, k]
    lb = log[B]                                   # [k, N...]
    # explicit loop over k keeps memory bounded for wide B
    m, k = A.shape
    out = np.zeros((m,) + B.shape[1:], dtype=np.int64)
    for j in range(k):
        a = A[:, j]                               # [m]
        bj = B[j]                                 # [N...]
        pj = exp[la[:, j].reshape((m,) + (1,) * bj.ndim) + lb[j]]
        pj = np.where((a.reshape((m,) + (1,) * bj.ndim) == 0) | (bj == 0),
                      0, pj)
        out ^= pj
    return out.astype(np.uint8 if w == 8 else np.uint16)


def gf_matvec(A: np.ndarray, x: np.ndarray, w: int = 8) -> np.ndarray:
    return gf_matmul(A, x.reshape(len(x), 1), w)[:, 0]


def gf_gaussian_inverse(M: np.ndarray, w: int = 8) -> np.ndarray:
    """Invert a square GF(2^w) matrix by Gauss-Jordan elimination.

    Raises ValueError if singular.  Mirrors the role of jerasure's
    jerasure_invert_matrix (decode-matrix construction, reference:
    src/erasure-code/jerasure/ErasureCodeJerasure.cc:265-274 call sites).
    """
    M = np.array(M, dtype=np.int64)
    n = M.shape[0]
    if M.shape != (n, n):
        raise ValueError("square matrix required")
    inv = np.eye(n, dtype=np.int64)
    for col in range(n):
        pivot = -1
        for r in range(col, n):
            if M[r, col]:
                pivot = r
                break
        if pivot < 0:
            raise ValueError("singular matrix over GF")
        if pivot != col:
            M[[col, pivot]] = M[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        pinv = gf_inv(M[col, col], w)
        M[col] = gf_mul(M[col], pinv, w)
        inv[col] = gf_mul(inv[col], pinv, w)
        for r in range(n):
            if r != col and M[r, col]:
                f = M[r, col]
                M[r] ^= gf_mul(M[col], f, w)
                inv[r] ^= gf_mul(inv[col], f, w)
    return inv.astype(np.uint8 if w == 8 else np.uint16)


# -------------------------------------------------------- matrix generators --

def vandermonde_parity(k: int, m: int, w: int = 8) -> np.ndarray:
    """Systematic Vandermonde parity block P [m,k] — reed_sol_van semantics.

    Rows of the raw Vandermonde are [1, i, i^2, ..] for evaluation points
    i = 0..k+m-1; the unique column-reduction to a systematic generator is
    P = V_bot @ inv(V_top).  Any k rows of [I; P] are then invertible (MDS).
    Reference behavior: jerasure reed_sol_van technique
    (src/erasure-code/jerasure/ErasureCodeJerasure.h:81).
    """
    if k + m > (1 << w):
        raise ValueError(f"k+m={k + m} exceeds field size 2^{w}")
    V = np.zeros((k + m, k), dtype=np.int64)
    for i in range(k + m):
        for j in range(k):
            V[i, j] = gf_pow(i, j, w)
    v_top_inv = gf_gaussian_inverse(V[:k], w)
    return gf_matmul(V[k:], v_top_inv, w)


def cauchy_orig_parity(k: int, m: int, w: int = 8) -> np.ndarray:
    """jerasure cauchy_orig: P[i,j] = 1 / (i XOR (m+j)).

    (reference technique: src/erasure-code/jerasure/ErasureCodeJerasure.h:174)
    """
    if k + m > (1 << w):
        raise ValueError("k+m exceeds field size")
    P = np.zeros((m, k), dtype=np.int64)
    for i in range(m):
        for j in range(k):
            P[i, j] = int(gf_inv(i ^ (m + j), w))
    dtype = np.uint8 if w == 8 else np.uint16
    return P.astype(dtype)


def cauchy_good_parity(k: int, m: int, w: int = 8) -> np.ndarray:
    """cauchy_orig normalized so row 0 and column 0 are all ones.

    jerasure's 'good' variant additionally scales rows to minimize bitmatrix
    ones (a CPU XOR-scheduling optimization); scaling by invertible
    diagonals preserves the MDS property and the decode relation, and the
    TPU bit-plane matmul cost is ones-count independent, so only the
    normalization is kept.  (reference technique:
    src/erasure-code/jerasure/ErasureCodeJerasure.h:183)
    """
    P = cauchy_orig_parity(k, m, w).astype(np.int64)
    # scale each column so row 0 becomes 1
    P = gf_mul(P, gf_inv(P[0])[None, :], w).astype(np.int64)
    # scale each row so column 0 becomes 1
    P = gf_mul(P, gf_inv(P[:, 0])[:, None], w).astype(np.int64)
    dtype = np.uint8 if w == 8 else np.uint16
    return P.astype(dtype)


def isa_rs_parity(k: int, m: int, w: int = 8) -> np.ndarray:
    """ISA-L gf_gen_rs_matrix parity rows: row t = [gen_t^0 .. gen_t^{k-1}],
    gen_t = 2^t.  Matches the reference 'isa' plugin's Vandermonde technique
    (src/erasure-code/isa/ErasureCodeIsa.cc:385).  Not guaranteed MDS for
    large m; kept for parity with the reference's option surface.
    """
    P = np.zeros((m, k), dtype=np.int64)
    gen = 1
    for t in range(m):
        p = 1
        for j in range(k):
            P[t, j] = p
            p = int(gf_mul(p, gen, w))
        gen = int(gf_mul(gen, 2, w))
    return P.astype(np.uint8 if w == 8 else np.uint16)


def isa_cauchy_parity(k: int, m: int, w: int = 8) -> np.ndarray:
    """ISA-L gf_gen_cauchy1_matrix parity rows: P[i,j] = 1/((k+i) XOR j)
    (src/erasure-code/isa/ErasureCodeIsa.cc:387)."""
    if k + m > (1 << w):
        raise ValueError("k+m exceeds field size")
    P = np.zeros((m, k), dtype=np.int64)
    for i in range(m):
        for j in range(k):
            P[i, j] = int(gf_inv((k + i) ^ j, w))
    return P.astype(np.uint8 if w == 8 else np.uint16)


def generator_matrix(parity: np.ndarray) -> np.ndarray:
    """Full systematic generator [I_k; P] — (k+m, k)."""
    m, k = parity.shape
    return np.concatenate(
        [np.eye(k, dtype=parity.dtype), parity], axis=0)


# ------------------------------------------------------------- bit matrices --

@functools.lru_cache(maxsize=None)
def _gf8_const_bitmatrices() -> np.ndarray:
    """[256, 8, 8] uint8: B_c with y_bits = B_c @ x_bits (mod 2) == c*x.

    B_c[b, j] = bit b of (c * alpha^j') where alpha^j' = x^j, i.e. column j
    holds the bits of c * 2^j.  This is the jerasure bitmatrix block
    convention (GF(2^8) multiplication is GF(2)-linear in the operand bits).
    """
    out = np.zeros((256, 8, 8), dtype=np.uint8)
    for c in range(256):
        v = c
        for j in range(8):
            for b in range(8):
                out[c, b, j] = (v >> b) & 1
            v <<= 1
            if v & 0x100:
                v ^= POLY8
    out.setflags(write=False)
    return out


def gf8_bitmatrix(M: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) matrix [m,k] into its GF(2) bit-matrix [8m, 8k].

    Block (i,j) is the 8x8 multiplication matrix of M[i,j]; multiplying the
    bit-expanded data vector by this matrix (mod 2) computes the GF matmul.
    This is the operand the TPU kernel feeds the MXU.
    """
    M = np.asarray(M, dtype=np.uint8)
    m, k = M.shape
    blocks = _gf8_const_bitmatrices()[M]          # [m, k, 8, 8]
    return blocks.transpose(0, 2, 1, 3).reshape(8 * m, 8 * k)


def bytes_to_bits(data: np.ndarray) -> np.ndarray:
    """[k, N] uint8 -> [8k, N] uint8 of 0/1; row 8*i+b is bit b of row i."""
    k, n = data.shape
    bits = ((data[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None])
            & 1)
    return bits.reshape(8 * k, n)


def bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    """[8m, N] 0/1 -> [m, N] uint8 (inverse of bytes_to_bits)."""
    m8, n = bits.shape
    m = m8 // 8
    b = bits.reshape(m, 8, n).astype(np.uint8)
    return (b << np.arange(8, dtype=np.uint8)[None, :, None]).sum(
        axis=1, dtype=np.uint32).astype(np.uint8)


def gf8_bitmatmul(M: np.ndarray, data: np.ndarray) -> np.ndarray:
    """GF(2^8) matmul computed via the bit-plane formulation (NumPy oracle).

    Semantically identical to gf_matmul(M, data); exists to validate the
    formulation the TPU kernel uses.
    """
    bm = gf8_bitmatrix(M)
    dbits = bytes_to_bits(np.asarray(data, dtype=np.uint8))
    pbits = (bm.astype(np.uint32) @ dbits.astype(np.uint32)) & 1
    return bits_to_bytes(pbits.astype(np.uint8))
