"""The benchmark's frozen arithmetic: the card's peaks, the codec's
bytes and the straw2 draw's operations, and the two rooflines.

Each roofline is a least time over a measured device time.  The least
time counts the work the cell completed, not the launches an
implementation made, so a later kernel is judged by the same yardstick.
"""
from __future__ import annotations

WEIGHT_IN = 0x10000

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3.
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer operations a second: 132 SMs x 64 INT32 lanes (H100
# white paper) x the 1.98 GHz clock that the data sheet's 67 TFLOP/s of
# FP32 implies (132 x 128 x 2 x 1.98e9).  Frozen from chip_smoke.py.
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# A straw2 draw must at least hash (x, item, r) with rjenkins hash3: the
# seed XOR of three words (2 three-input LOP3s), then five mixes of nine
# lines, each line a three-input subtract (IADD3), a shift (SHF) and an
# XOR (LOP3): 2 + 5 x 9 x 3 = 137 instructions.  The ln lookup, the
# division and the compare are left out, so this bounds from below.
OPS_PER_DRAW = 2 + 5 * 9 * 3
# the crush_ln table: 65,536 int64 entries, read at least once
LN_TABLE_BYTES = 65536 * 8


def encode_bytes(objects: int, stripes: int, k: int, m: int,
                 unit: int) -> int:
    """An encode reads each data byte once and writes each parity byte
    once."""
    return objects * stripes * (k + m) * unit


def decode_bytes(stripes: int, k: int, erased_data: int,
                 unit: int) -> int:
    """A degraded read decodes only when a data chunk is erased: it reads
    k chunks and writes the erased data chunks."""
    return stripes * (k + erased_data) * unit if erased_data else 0


def codec_least_s(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S


def placement_least_s(draws: float, sweeps: int) -> float:
    """The larger of the draws' operations at the integer rate and one
    read of the ln table a sweep at the memory rate."""
    return max(draws * OPS_PER_DRAW / INT32_OPS_PER_S,
               sweeps * LN_TABLE_BYTES / HBM_BYTES_PER_S)


def roofline_pct(least_s: float, device_s: float):
    """Least time as a share of the device time; None without one."""
    if not device_s or device_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / device_s
