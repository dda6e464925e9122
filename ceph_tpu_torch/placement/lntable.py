"""The straw2 fixed-point log table.

The reference computes `crush_ln(u)` (2^44*log2(u+1) in fixed point,
src/crush/mapper.c:248-290) from two small tables whose published generating
formulas do NOT reproduce the shipped data (235/256 entries of __LL_tbl
deviate — a long-standing upstream quirk preserved for compatibility).  Since
straw2 only ever evaluates u in [0, 0xffff] (mapper.c:337-350), the entire
pipeline collapses to one 65536-entry LUT, extracted once from the reference
tables by scripts/gen_golden.py and stored as packaged data.

`STRAW2_LN[u] = crush_ln(u) - 0x1000000000000` is the (negative) numerator of
the straw2 draw; the draw itself is `trunc_div(STRAW2_LN[u], weight)`
(mapper.c:350-358).
"""
from __future__ import annotations

import functools
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "data", "crush_ln_u16.npy")

LN_SHIFT = 0x1000000000000  # 2^48; mapper.c:350
S64_MIN = -(2**63)


@functools.lru_cache(maxsize=None)
def crush_ln_lut() -> np.ndarray:
    """int64[65536]: crush_ln(u) for u in [0, 0xffff]."""
    lut = np.load(_DATA)
    lut.setflags(write=False)
    return lut


@functools.lru_cache(maxsize=None)
def straw2_ln_lut() -> np.ndarray:
    """int64[65536]: crush_ln(u) - 2^48 — the negative draw numerator."""
    lut = crush_ln_lut() - np.int64(LN_SHIFT)
    lut.setflags(write=False)
    return lut


def straw2_draw(u: int, weight: int) -> int:
    """Scalar straw2 draw: trunc_div(ln, weight); S64_MIN for weight==0.

    C's div64_s64 truncates toward zero; ln <= 0 and weight > 0, so
    trunc(ln/w) == -((-ln) // w).
    """
    if weight == 0:
        return S64_MIN
    ln = int(straw2_ln_lut()[u])
    return -((-ln) // weight)
