"""RAID-6 (m=2) minimal-density bitmatrix constructions.

The reference jerasure plugin ships three bitmatrix-native techniques —
liberation, blaum_roth, liber8tion (declared at
src/erasure-code/jerasure/ErasureCodeJerasure.h:192,229,240, prepared by
liberation_coding_bitmatrix / blaum_roth_coding_bitmatrix /
liber8tion_coding_bitmatrix in the vendored jerasure library, an EMPTY
submodule in this checkout).  They are GF(2) bitmatrix codes operating
on packet (plane) regions — exactly the layout of ops/gf2.py — with
far sparser Q matrices than a Cauchy expansion, which made them the
fast RAID-6 path on CPUs and makes them the cheapest XOR schedules
here.

Structure shared by all three: the parity bitmatrix is

        [ I   I   ...  I  ]      (P = XOR of all data chunks)
        [X_0 X_1 ... X_{k-1}]    (Q row; X_i are w x w 0/1 matrices)

and the code is MDS for 2 erasures iff every X_i and every X_i ^ X_j
is invertible over GF(2).

Constructions:

  * blaum_roth (w with w+1 prime, k <= w): X_i = C^i where C is the
    companion matrix of multiplication by x in the polynomial ring
    GF(2)[x] / (1 + x + ... + x^w) — the exact Blaum-Roth independent-
    parity construction; deterministic, no search.
  * liberation (w prime, k <= w): X_0 = I and X_i = sigma^i (cyclic
    down-shift by i) plus ONE extra bit, the minimal-density shape of
    Plank's Liberation codes.  The published extra-bit formula is not
    reproducible without the vendored library, so the extra position is
    found by deterministic search over the w^2 candidates (first one
    preserving pairwise invertibility wins); the resulting Q density is
    the Liberation minimum, k*w + k - 1 ones.
  * liber8tion (w=8, k <= 8): same minimal-density shape at w=8 (not
    prime).  The original liber8tion matrices were themselves FOUND by
    computer search (Plank, "The RAID-6 Liber8tion Code"); this module
    re-runs such a search deterministically over (shift, extra-bit)
    candidates with backtracking.

All constructions are validated for the full 2-erasure MDS property at
build time and are deterministic (same matrices every process), so the
non-regression corpus can pin their output bytes.
"""
from __future__ import annotations

import functools

import numpy as np

from ..ops import gf2


def _shift_matrix(w: int, s: int) -> np.ndarray:
    """sigma^s: X @ v rotates v down by s (X[j, (j + s) % w] = 1)."""
    X = np.zeros((w, w), dtype=np.uint8)
    for j in range(w):
        X[j, (j + s) % w] = 1
    return X


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    d = 2
    while d * d <= n:
        if n % d == 0:
            return False
        d += 1
    return True


def _pairwise_ok(X: np.ndarray, chosen: list) -> bool:
    if not gf2.gf2_invertible(X):
        return False
    return all(gf2.gf2_invertible(X ^ Y) for Y in chosen)


def _assemble(k: int, w: int, xs: list) -> np.ndarray:
    """[2w, kw] parity bitmatrix from the Q-row blocks."""
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    eye = np.eye(w, dtype=np.uint8)
    for i in range(k):
        bm[:w, i * w:(i + 1) * w] = eye
        bm[w:, i * w:(i + 1) * w] = xs[i]
    return bm


@functools.lru_cache(maxsize=None)
def blaum_roth_bitmatrix(k: int, w: int) -> np.ndarray:
    """Blaum-Roth: X_i = (mult by x^i mod 1+x+...+x^w).  w+1 prime,
    k <= w (reference surface: ErasureCodeJerasure.h:229)."""
    if not _is_prime(w + 1):
        raise ValueError(f"blaum_roth requires w+1 prime, got w={w}")
    if k > w:
        raise ValueError(f"blaum_roth requires k <= w ({k} > {w})")
    # companion matrix: x * x^j = x^{j+1}; x^w = sum_{t<w} x^t
    C = np.zeros((w, w), dtype=np.uint8)
    for j in range(w - 1):
        C[j + 1, j] = 1
    C[:, w - 1] = 1
    xs, X = [], np.eye(w, dtype=np.uint8)
    for i in range(k):
        xs.append(X)
        X = gf2.gf2_matmul(C, X)
    bm = _assemble(k, w, xs)
    _validate_mds(bm, k, w, "blaum_roth")
    return bm


def _backtrack(k: int, candidates) -> list | None:
    """Depth-first search for k pairwise-compatible Q blocks.
    ``candidates(i)`` yields the column-i candidates in deterministic
    order; the first complete assignment wins (same matrices every
    process, so corpus pinning is stable)."""
    def go(i, chosen):
        if i == k:
            return chosen
        for X in candidates(i):
            if _pairwise_ok(X, chosen):
                out = go(i + 1, chosen + [X])
                if out is not None:
                    return out
        return None
    return go(0, [])


@functools.lru_cache(maxsize=None)
def liberation_bitmatrix(k: int, w: int) -> np.ndarray:
    """Liberation shape: X_0 = I, X_i = sigma^i + one searched extra bit
    (w prime, k <= w; reference surface: ErasureCodeJerasure.h:192).
    Backtracking over the extra-bit positions (greedy dead-ends exist,
    e.g. k=5 w=7)."""
    if not _is_prime(w):
        raise ValueError(f"liberation requires prime w, got {w}")
    if k > w:
        raise ValueError(f"liberation requires k <= w ({k} > {w})")

    def candidates(i):
        if i == 0:
            yield np.eye(w, dtype=np.uint8)
            return
        base = _shift_matrix(w, i)
        for r in range(w):
            for c in range(w):
                if base[r, c]:
                    continue
                X = base.copy()
                X[r, c] = 1
                yield X

    xs = _backtrack(k, candidates)
    if xs is None:  # pragma: no cover - prime w always succeeds
        raise ValueError(f"liberation search failed for k={k} w={w}")
    bm = _assemble(k, w, xs)
    _validate_mds(bm, k, w, "liberation")
    return bm


@functools.lru_cache(maxsize=None)
def liber8tion_bitmatrix(k: int, w: int = 8) -> np.ndarray:
    """Liber8tion surface at w=8 (m=2, k <= 8, packet layout;
    reference: ErasureCodeJerasure.h:240).

    The original liber8tion matrices were minimum-density tables found
    by a large computer search (Plank, "The RAID-6 Liber8tion Code")
    and shipped inside the vendored jerasure library — an empty
    submodule here, and not reconstructible from a formula.  Shift-plus-
    extra-bit families cannot work at w=8 at all (sigma^a ^ sigma^b is
    ALWAYS singular when w is a power of two: x^d + 1 shares the factor
    x + 1 with x^8 - 1), so this build fills the technique with the
    classic deterministic RAID-6 bitmatrix: X_i = C^i for C the
    companion matrix of the GF(2^8) polynomial 0x11d (multiplication by
    alpha^i).  MDS holds because C^a ^ C^b = C^b (C^{a-b} ^ I) and
    alpha^d != 1 for 0 < d < 255.  Same (k, m, w, layout) surface and
    packet semantics; Q density is ~2x the unpublished minimum, which
    the mask-XOR device kernel is insensitive to.
    """
    if w != 8:
        raise ValueError("liber8tion is defined for w=8")
    if k > 8:
        raise ValueError(f"liber8tion requires k <= 8, got {k}")
    # companion matrix of x^8 + x^4 + x^3 + x^2 + 1 (POLY8 = 0x11d)
    C = np.zeros((w, w), dtype=np.uint8)
    for j in range(w - 1):
        C[j + 1, j] = 1
    for b in range(w):
        if (0x11D >> b) & 1:
            C[b, w - 1] = 1
    xs, X = [], np.eye(w, dtype=np.uint8)
    for i in range(k):
        xs.append(X)
        X = gf2.gf2_matmul(C, X)
    bm = _assemble(k, w, xs)
    _validate_mds(bm, k, w, "liber8tion")
    return bm


def _validate_mds(bm: np.ndarray, k: int, w: int, name: str) -> None:
    """Assert every 2-erasure pattern is decodable (X_i, X_i^X_j
    invertible) — the build-time contract."""
    xs = [bm[w:, i * w:(i + 1) * w] for i in range(k)]
    for i in range(k):
        if not gf2.gf2_invertible(xs[i]):
            raise AssertionError(f"{name}: X_{i} singular")
        for j in range(i):
            if not gf2.gf2_invertible(xs[i] ^ xs[j]):
                raise AssertionError(f"{name}: X_{i}^X_{j} singular")
