"""The 'shec' codec — Shingled Erasure Code.

Re-creates the behavior of the reference SHEC plugin
(src/erasure-code/shec/ErasureCodeShec.cc): the generator is a
reed_sol_van parity matrix with each parity row masked down to a cyclic
shingle window of the data chunks (shec_reedsolomon_coding_matrix,
ErasureCodeShec.cc:514-531: row rr keeps columns outside
[start, end) where end = rr*k/m %k, start = (rr+c)*k/m %k), trading extra
storage (c, the durability estimator) for cheaper single-failure repair:
a lost chunk is rebuilt from one parity's window instead of k chunks.

SHEC is deliberately not MDS, so decode selects an invertible row subset
by greedy rank-revealing elimination over all available rows (the role of
shec_make_decoding_matrix, ErasureCodeShec.cc:535), and
minimum_to_decode searches for the smallest parity window covering the
erasures (the multiple-solution search, ErasureCodeShec.cc:113).

Constraints mirror the reference parse(): k <= 12, k+m <= 20, m <= k,
0 < c <= m (ErasureCodeShec.cc:300-341).

The 'multiple' technique's (m1,c1) row-group split is re-derived as an
exhaustive search minimizing the average single-failure repair width; it
is a valid SHEC layout though the split choice may differ from the
reference's heuristic for some (k,m,c).

Port of ``ceph_tpu/ec/plugin_shec.py``: the codec is built on the
caller's device (the package default when None) and computes on the
host, as the reference's does.
"""
from __future__ import annotations

from typing import List, Sequence, Set, Tuple

import numpy as np

from .. import resolve_device
from ..ops import gf
from .interface import ErasureCodeError, ErasureCodeProfile, SubChunkPlan
from .matrix_codec import MatrixCodec

DEFAULT_K, DEFAULT_M, DEFAULT_C = 4, 3, 2


def _shingle_mask(parity: np.ndarray, rows: range, m_grp: int,
                  c_grp: int, k: int) -> None:
    """Zero columns in the cyclic window [start, end) per group row."""
    if m_grp <= 0:
        return
    for gi, rr in enumerate(rows):
        end = ((gi * k) // m_grp) % k
        start = (((gi + c_grp) * k) // m_grp) % k
        cc = start
        while cc != end:
            parity[rr, cc] = 0
            cc = (cc + 1) % k


def shec_parity(k: int, m: int, c: int, technique: str = "multiple"
                ) -> np.ndarray:
    base = gf.vandermonde_parity(k, m)
    parity = base.astype(np.int64)
    if technique == "single" or m == 1 or c == m:
        _shingle_mask(parity, range(m), m, c, k)
        return parity.astype(np.uint8)
    # 'multiple': split rows into two shingle groups (m1,c1)+(m2,c2),
    # minimizing average repair width over single data failures
    best = None
    for m1 in range(0, m + 1):
        for c1 in range(0, c + 1):
            m2, c2 = m - m1, c - c1
            if (m1 == 0) != (c1 == 0):
                continue
            if (m2 == 0) != (c2 == 0):
                continue
            if m1 and c1 > m1 or m2 and c2 > m2:
                continue
            cand = base.astype(np.int64).copy()
            _shingle_mask(cand, range(m1), m1, c1, k)
            _shingle_mask(cand, range(m1, m), m2, c2, k)
            if np.any((cand != 0).sum(axis=1) == 0):
                continue
            # every data chunk must be covered by some parity
            if np.any((cand != 0).sum(axis=0) == 0):
                continue
            width = min((cand[j] != 0).sum() for j in range(m))
            score = ((cand != 0).sum(), width)
            if best is None or score < best[0]:
                best = (score, cand)
    if best is None:
        raise ErasureCodeError(f"no valid shec layout for k={k} m={m} c={c}")
    return best[1].astype(np.uint8)


class ErasureCodeShec(MatrixCodec):
    def __init__(self, device=None) -> None:
        super().__init__()
        self.device = resolve_device(device)

    def init(self, profile: ErasureCodeProfile) -> None:
        technique = profile.get("technique", "multiple")
        if technique not in ("single", "multiple"):
            raise ErasureCodeError(
                f"shec technique must be single|multiple, got {technique!r}")
        k = self.profile_int(profile, "k", DEFAULT_K, minimum=1)
        m = self.profile_int(profile, "m", DEFAULT_M, minimum=1)
        c = self.profile_int(profile, "c", DEFAULT_C, minimum=1)
        # reference bounds (ErasureCodeShec.cc:300-341)
        if k > 12:
            raise ErasureCodeError(f"shec k={k} must be <= 12")
        if k + m > 20:
            raise ErasureCodeError(f"shec k+m={k + m} must be <= 20")
        if m > k:
            raise ErasureCodeError(f"shec m={m} must be <= k={k}")
        if c > m:
            raise ErasureCodeError(f"shec c={c} must be <= m={m}")
        self.c = c
        self.set_matrix(shec_parity(k, m, c, technique), 8)
        self._profile = dict(profile)
        self._profile.setdefault("plugin", "shec")
        self._profile["technique"] = technique
        self._profile.update(k=str(k), m=str(m), c=str(c))

    # ----------------------------------------------- row-space solution --
    def _pick_rows(self, available: Sequence[int], erased: Sequence[int]
                   ) -> List[int]:
        """Greedy rank-revealing choice of k independent available rows."""
        G = self.generator().astype(np.int64)
        chosen: List[int] = []
        basis = np.zeros((0, self.k), dtype=np.int64)
        for c_id in sorted(available):
            cand = np.concatenate([basis, G[c_id][None, :]])
            rank = _gf_rank(cand)
            if rank > basis.shape[0]:
                basis = _gf_row_reduce(cand)[:rank]
                chosen.append(c_id)
            if len(chosen) == self.k:
                return chosen
        raise ErasureCodeError(
            f"shec: available rows {sorted(available)} do not span; "
            f"cannot rebuild {sorted(erased)}")

    def decode_matrix(self, available_ids, erased_ids):
        """R with erased = R @ available — unlike the MDS base, the
        available set may be SMALLER than k (a local shingle window): the
        erased rows just have to lie in the span of the available rows
        (the role of shec_make_decoding_matrix)."""
        avail = sorted(set(available_ids))
        erased = sorted(erased_ids)
        key = (tuple(avail), tuple(erased))
        hit = self._cache.get(key)
        if hit is not None:
            return hit, avail
        G = self.generator().astype(np.int64)
        R = _gf_solve_rowspace(G[avail], G[erased])
        if R is None:
            raise ErasureCodeError(
                f"shec: cannot express chunks {erased} from {avail}")
        self._cache.put(key, R)
        return R, avail

    def decode_chunks(self, available_ids, chunks, erased_ids):
        erased = sorted(erased_ids)
        if not erased:
            return np.zeros((0,) + tuple(chunks.shape[1:]), dtype=np.uint8)
        R, used = self.decode_matrix(available_ids, erased)
        order = list(available_ids)
        rows = np.stack([np.asarray(chunks[order.index(c)], dtype=np.uint8)
                         for c in used])
        return gf.gf_matmul(R, rows, self.w).astype(np.uint8)

    # ------------------------------------------------- minimum_to_decode --
    def minimum_to_decode(self, want_to_read: Set[int],
                          available: Set[int]) -> SubChunkPlan:
        if want_to_read <= available:
            return {c: [(0, 1)] for c in want_to_read}
        erased = want_to_read - available
        P = self.parity.astype(np.int64)
        if len(erased) == 1:
            (e,) = erased
            best: Tuple[int, Set[int]] | None = None
            if e < self.k:
                for j in range(self.m):
                    if P[j, e] and (self.k + j) in available:
                        need = {cc for cc in range(self.k)
                                if P[j, cc] and cc != e}
                        if need <= available:
                            sol = need | {self.k + j}
                            if best is None or len(sol) < len(best[1]):
                                best = (j, sol)
            else:
                j = e - self.k
                need = {cc for cc in range(self.k) if P[j, cc]}
                if need <= available:
                    best = (j, need)
            if best is not None:
                return {c: [(0, 1)] for c in best[1]}
        # general: the rank-revealing row choice
        rows = self._pick_rows(sorted(available), sorted(erased))
        return {c: [(0, 1)] for c in rows}


def _gf_solve_rowspace(A: np.ndarray, T: np.ndarray):
    """Find R with T = R @ A over GF(2^8), or None if T is outside A's
    row space.  Gaussian elimination over A's columns, with an identity
    block tracking the combination coefficients."""
    n, k = A.shape
    aug = np.concatenate(
        [A.astype(np.int64), np.eye(n, dtype=np.int64)], axis=1)
    pivots = []        # (row, col) with col < k
    r = 0
    for col in range(k):
        pivot = None
        for i in range(r, n):
            if aug[i, col]:
                pivot = i
                break
        if pivot is None:
            continue
        aug[[r, pivot]] = aug[[pivot, r]]
        aug[r] = gf.gf_mul(aug[r], gf.gf_inv(aug[r, col]))
        for i in range(n):
            if i != r and aug[i, col]:
                aug[i] ^= gf.gf_mul(aug[r], aug[i, col])
        pivots.append((r, col))
        r += 1
        if r == n:
            break
    R = np.zeros((T.shape[0], n), dtype=np.int64)
    for ti in range(T.shape[0]):
        residual = T[ti].astype(np.int64).copy()
        coeffs = np.zeros(n, dtype=np.int64)
        for row, col in pivots:
            if residual[col]:
                f = residual[col]          # pivot normalized to 1
                residual ^= gf.gf_mul(aug[row, :k], f)
                coeffs ^= gf.gf_mul(aug[row, k:], f)
        if residual.any():
            return None
        R[ti] = coeffs
    return R.astype(np.uint8)


def _gf_row_reduce(M: np.ndarray) -> np.ndarray:
    M = M.astype(np.int64).copy()
    rows, cols = M.shape
    r = 0
    for col in range(cols):
        pivot = None
        for i in range(r, rows):
            if M[i, col]:
                pivot = i
                break
        if pivot is None:
            continue
        M[[r, pivot]] = M[[pivot, r]]
        M[r] = gf.gf_mul(M[r], gf.gf_inv(M[r, col]))
        for i in range(rows):
            if i != r and M[i, col]:
                M[i] ^= gf.gf_mul(M[r], M[i, col])
        r += 1
        if r == rows:
            break
    return M


def _gf_rank(M: np.ndarray) -> int:
    R = _gf_row_reduce(M)
    return int((R.any(axis=1)).sum())


def _factory(profile: ErasureCodeProfile, device=None):
    codec = ErasureCodeShec(device)
    codec.init(profile)
    return codec


def register(registry) -> None:
    registry.add("shec", _factory)
