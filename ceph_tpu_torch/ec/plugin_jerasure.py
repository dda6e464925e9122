"""The 'jerasure' codec family — baseline RS/Cauchy techniques.

Port of ``ceph_tpu/ec/plugin_jerasure.py``; the matrices are the
reference's.

Re-creates the technique surface of the reference jerasure plugin
(src/erasure-code/jerasure/ErasureCodeJerasure.h:81-240) from first
principles (the GF libraries are empty submodules in the reference
checkout; ops/gf.py re-derives the math):

  * reed_sol_van    — systematic Vandermonde RS, w in {8, 16}
  * reed_sol_r6_op  — RAID-6 P/Q (m == 2; rows [1..1], [1,2,4,...])
  * cauchy_orig     — Cauchy generator 1/(i ^ (m+j))
  * cauchy_good     — normalized Cauchy

The bitmatrix techniques run on the GF(2) plane layout:

  * liberation     — RAID-6 minimal-density bitmatrix (m=2, prime w)
  * blaum_roth     — RAID-6 ring construction (m=2, w+1 prime)
  * liber8tion     — RAID-6 search-built bitmatrix (m=2, w=8)

(constructions in ec/bitmatrix_raid6.py; data path is the masked
region-XOR kernel over packet planes, the layout jerasure's schedules
use — src/erasure-code/jerasure/ErasureCodeJerasure.cc:162,274.)

Every codec is built on the caller's device (the package default when
None).  The matrix techniques compute on the host in NumPy, as the
reference's do; the bitmatrix techniques' batched paths run kernel K1 on
that device (ec/bitmatrix_codec.py).
"""
from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..ops import gf
from .bitmatrix_codec import BitmatrixCodec
from .bitmatrix_raid6 import (blaum_roth_bitmatrix, liber8tion_bitmatrix,
                              liberation_bitmatrix)
from .interface import ErasureCodeError, ErasureCodeProfile
from .matrix_codec import MatrixCodec

TECHNIQUES = ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig", "cauchy_good",
              "liberation", "blaum_roth", "liber8tion")

DEFAULT_K = 2
DEFAULT_M = 1
DEFAULT_W = 8


class ErasureCodeJerasure(MatrixCodec):
    def __init__(self, device=None) -> None:
        super().__init__()
        self.device = resolve_device(device)

    def init(self, profile: ErasureCodeProfile) -> None:
        technique = profile.get("technique", "reed_sol_van")
        k = self.profile_int(profile, "k", DEFAULT_K, minimum=1)
        m = self.profile_int(profile, "m", DEFAULT_M, minimum=1)
        w = self.profile_int(profile, "w", DEFAULT_W)

        if technique == "reed_sol_van":
            if w not in (8, 16):
                raise ErasureCodeError(
                    f"reed_sol_van supports w in (8, 16), got {w}")
            try:
                parity = gf.vandermonde_parity(k, m, w)
            except ValueError as e:
                raise ErasureCodeError(str(e)) from e
        elif technique == "reed_sol_r6_op":
            if m != 2:
                raise ErasureCodeError("reed_sol_r6_op requires m=2")
            if w not in (8, 16):
                raise ErasureCodeError("reed_sol_r6_op supports w in (8,16)")
            parity = np.zeros((2, k), dtype=np.int64)
            parity[0] = 1
            for j in range(k):
                parity[1, j] = gf.gf_pow(2, j, w)
            parity = parity.astype(np.uint8 if w == 8 else np.uint16)
        elif technique == "cauchy_orig":
            if w != 8:
                raise ErasureCodeError("cauchy_orig implemented for w=8")
            try:
                parity = gf.cauchy_orig_parity(k, m, w)
            except ValueError as e:
                raise ErasureCodeError(str(e)) from e
        elif technique == "cauchy_good":
            if w != 8:
                raise ErasureCodeError("cauchy_good implemented for w=8")
            try:
                parity = gf.cauchy_good_parity(k, m, w)
            except ValueError as e:
                raise ErasureCodeError(str(e)) from e
        else:  # pragma: no cover - _factory validates technique names
            raise ErasureCodeError(f"not a matrix technique: {technique}")
        self.set_matrix(parity, w)
        self._profile = dict(profile)
        self._profile.setdefault("plugin", "jerasure")
        self._profile["technique"] = technique
        self._profile.update(k=str(k), m=str(m), w=str(w))


BITMATRIX_TECHNIQUES = ("liberation", "blaum_roth", "liber8tion")
# per-technique default w, matching jerasure's common usage
_BITMATRIX_DEFAULT_W = {"liberation": 7, "blaum_roth": 6, "liber8tion": 8}


class ErasureCodeJerasureBitmatrix(BitmatrixCodec):
    """The three RAID-6 bitmatrix techniques (m forced to 2)."""

    def init(self, profile: ErasureCodeProfile) -> None:
        technique = profile["technique"]
        k = self.profile_int(profile, "k", DEFAULT_K, minimum=1)
        m = self.profile_int(profile, "m", 2)
        w = self.profile_int(profile, "w",
                             _BITMATRIX_DEFAULT_W[technique])
        if m != 2:
            raise ErasureCodeError(f"{technique} requires m=2, got {m}")
        try:
            if technique == "liberation":
                bm = liberation_bitmatrix(k, w)
            elif technique == "blaum_roth":
                bm = blaum_roth_bitmatrix(k, w)
            else:
                bm = liber8tion_bitmatrix(k, w)
        except ValueError as e:
            raise ErasureCodeError(str(e)) from e
        self.set_bitmatrix(bm, k, m, w)
        self._profile = dict(profile)
        self._profile.setdefault("plugin", "jerasure")
        self._profile["technique"] = technique
        self._profile.update(k=str(k), m=str(m), w=str(w))


def _factory(profile: ErasureCodeProfile, device=None):
    """Single validation point for the technique whitelist; bitmatrix
    techniques dispatch to the GF(2) codec class."""
    technique = profile.get("technique", "reed_sol_van")
    if technique not in TECHNIQUES:
        raise ErasureCodeError(
            f"technique={technique!r} not in {TECHNIQUES}")
    codec = (ErasureCodeJerasureBitmatrix(device)
             if technique in BITMATRIX_TECHNIQUES
             else ErasureCodeJerasure(device))
    codec.init(dict(profile, technique=technique))
    return codec


def register(registry) -> None:
    registry.add("jerasure", _factory)
