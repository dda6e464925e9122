"""rjenkins1 32-bit mixing hash — CRUSH's only randomness source.

Copy of ``ceph_tpu/ops/hashing.py`` whose batched hashes are torch code.

Three implementations sharing one spec (reference: src/crush/hash.c:12-90):

  * python-int scalars (`hash1`..`hash5`)   — used by the scalar reference mapper
  * numpy vectorized  (`np_hash2/np_hash3`) — host-side batch utilities
  * torch vectorized  (`jx_hash2/3/4`)     — the batched placement mapper on the card
    (int64 tensors holding u32 values; the names are the reference's)

All arithmetic is modulo 2^32; the seed constant is 1315423911 (hash.c:24).
The mix schedule (which operands feed each 9-op mixing round) differs per arity
and is part of the wire-compatible spec.
"""
from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
SEED = 1315423911
MIX_X = 231232
MIX_Y = 1232


# ---------------------------------------------------------------- scalar ----

def _mix(a: int, b: int, c: int):
    a = (a - b) & M32; a = (a - c) & M32; a = a ^ (c >> 13)
    b = (b - c) & M32; b = (b - a) & M32; b = (b ^ (a << 8)) & M32
    c = (c - a) & M32; c = (c - b) & M32; c = c ^ (b >> 13)
    a = (a - b) & M32; a = (a - c) & M32; a = a ^ (c >> 12)
    b = (b - c) & M32; b = (b - a) & M32; b = (b ^ (a << 16)) & M32
    c = (c - a) & M32; c = (c - b) & M32; c = c ^ (b >> 5)
    a = (a - b) & M32; a = (a - c) & M32; a = a ^ (c >> 3)
    b = (b - c) & M32; b = (b - a) & M32; b = (b ^ (a << 10)) & M32
    c = (c - a) & M32; c = (c - b) & M32; c = c ^ (b >> 15)
    return a, b, c


def hash1(a: int) -> int:
    a &= M32
    h = (SEED ^ a) & M32
    b, x, y = a, MIX_X, MIX_Y
    b, x, h = _mix(b, x, h)
    y, a, h = _mix(y, a, h)
    return h


def hash2(a: int, b: int) -> int:
    a &= M32; b &= M32
    h = (SEED ^ a ^ b) & M32
    x, y = MIX_X, MIX_Y
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def hash3(a: int, b: int, c: int) -> int:
    a &= M32; b &= M32; c &= M32
    h = (SEED ^ a ^ b ^ c) & M32
    x, y = MIX_X, MIX_Y
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def hash4(a: int, b: int, c: int, d: int) -> int:
    a &= M32; b &= M32; c &= M32; d &= M32
    h = (SEED ^ a ^ b ^ c ^ d) & M32
    x, y = MIX_X, MIX_Y
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def hash5(a: int, b: int, c: int, d: int, e: int) -> int:
    a &= M32; b &= M32; c &= M32; d &= M32; e &= M32
    h = (SEED ^ a ^ b ^ c ^ d ^ e) & M32
    x, y = MIX_X, MIX_Y
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    e, x, h = _mix(e, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    d, x, h = _mix(d, x, h)
    y, e, h = _mix(y, e, h)
    return h


def str_hash_rjenkins(data: bytes) -> int:
    """Object-name hash (reference: src/common/ceph_hash.cc
    ceph_str_hash_rjenkins) — the object→ps step of placement."""
    a = 0x9E3779B9
    b = a
    c = 0
    i, length = 0, len(data)
    left = length
    while left >= 12:
        a = (a + int.from_bytes(data[i:i + 4], "little")) & M32
        b = (b + int.from_bytes(data[i + 4:i + 8], "little")) & M32
        c = (c + int.from_bytes(data[i + 8:i + 12], "little")) & M32
        a, b, c = _mix(a, b, c)
        i += 12
        left -= 12
    c = (c + length) & M32
    tail = data[i:]
    if left >= 11:
        c = (c + (tail[10] << 24)) & M32
    if left >= 10:
        c = (c + (tail[9] << 16)) & M32
    if left >= 9:
        c = (c + (tail[8] << 8)) & M32
    if left >= 8:
        b = (b + (tail[7] << 24)) & M32
    if left >= 7:
        b = (b + (tail[6] << 16)) & M32
    if left >= 6:
        b = (b + (tail[5] << 8)) & M32
    if left >= 5:
        b = (b + tail[4]) & M32
    if left >= 4:
        a = (a + (tail[3] << 24)) & M32
    if left >= 3:
        a = (a + (tail[2] << 16)) & M32
    if left >= 2:
        a = (a + (tail[1] << 8)) & M32
    if left >= 1:
        a = (a + tail[0]) & M32
    a, b, c = _mix(a, b, c)
    return c


# ----------------------------------------------------------------- numpy ----

def _np_mix(a, b, c):
    a = a - b; a = a - c; a = a ^ (c >> np.uint32(13))
    b = b - c; b = b - a; b = b ^ (a << np.uint32(8))
    c = c - a; c = c - b; c = c ^ (b >> np.uint32(13))
    a = a - b; a = a - c; a = a ^ (c >> np.uint32(12))
    b = b - c; b = b - a; b = b ^ (a << np.uint32(16))
    c = c - a; c = c - b; c = c ^ (b >> np.uint32(5))
    a = a - b; a = a - c; a = a ^ (c >> np.uint32(3))
    b = b - c; b = b - a; b = b ^ (a << np.uint32(10))
    c = c - a; c = c - b; c = c ^ (b >> np.uint32(15))
    return a, b, c


def np_hash2(a, b):
    a = np.asarray(a, np.uint32); b = np.asarray(b, np.uint32)
    h = np.uint32(SEED) ^ a ^ b
    x = np.broadcast_to(np.uint32(MIX_X), h.shape).copy()
    y = np.broadcast_to(np.uint32(MIX_Y), h.shape).copy()
    a, b, h = _np_mix(a, b, h)
    x, a, h = _np_mix(x, a, h)
    b, y, h = _np_mix(b, y, h)
    return h


def np_hash3(a, b, c):
    a = np.asarray(a, np.uint32); b = np.asarray(b, np.uint32)
    c = np.asarray(c, np.uint32)
    h = np.uint32(SEED) ^ a ^ b ^ c
    x = np.broadcast_to(np.uint32(MIX_X), h.shape).copy()
    y = np.broadcast_to(np.uint32(MIX_Y), h.shape).copy()
    a, b, h = _np_mix(a, b, h)
    c, x, h = _np_mix(c, x, h)
    y, a, h = _np_mix(y, a, h)
    b, x, h = _np_mix(b, x, h)
    y, c, h = _np_mix(y, c, h)
    return h


# ----------------------------------------------------------------- torch ----
# torch's uint32 has limited operator support, so the batched hashes run in
# int64 holding the u32 value: every add, subtract and left shift is masked
# back to 32 bits, right shifts of a value in [0, 2^32) are logical, and XOR
# of two in-range values stays in range.

def _t_u32(v):
    """Any integer tensor -> int64 tensor of its values mod 2^32."""
    import torch
    return v.to(torch.int64) & M32


def _t_mix(a, b, c):
    a = (a - b) & M32; a = (a - c) & M32; a = a ^ (c >> 13)
    b = (b - c) & M32; b = (b - a) & M32; b = b ^ ((a << 8) & M32)
    c = (c - a) & M32; c = (c - b) & M32; c = c ^ (b >> 13)
    a = (a - b) & M32; a = (a - c) & M32; a = a ^ (c >> 12)
    b = (b - c) & M32; b = (b - a) & M32; b = b ^ ((a << 16) & M32)
    c = (c - a) & M32; c = (c - b) & M32; c = c ^ (b >> 5)
    a = (a - b) & M32; a = (a - c) & M32; a = a ^ (c >> 3)
    b = (b - c) & M32; b = (b - a) & M32; b = b ^ ((a << 10) & M32)
    c = (c - a) & M32; c = (c - b) & M32; c = c ^ (b >> 15)
    return a, b, c


def _t_start(*vals):
    """Broadcast the operands (as u32 values in int64) and seed h."""
    import torch
    vals = torch.broadcast_tensors(*[_t_u32(v) for v in vals])
    h = vals[0] ^ SEED
    for v in vals[1:]:
        h = h ^ v
    return vals, h, torch.full_like(h, MIX_X), torch.full_like(h, MIX_Y)


def jx_hash2(a, b):
    """crush_hash32_rjenkins1_2 over integer tensors -> int64 tensor of
    u32 values (the batched twin of hash2)."""
    (a, b), h, x, y = _t_start(a, b)
    a, b, h = _t_mix(a, b, h)
    x, a, h = _t_mix(x, a, h)
    b, y, h = _t_mix(b, y, h)
    return h


def jx_hash3(a, b, c):
    """crush_hash32_rjenkins1_3 over integer tensors (see jx_hash2)."""
    (a, b, c), h, x, y = _t_start(a, b, c)
    a, b, h = _t_mix(a, b, h)
    c, x, h = _t_mix(c, x, h)
    y, a, h = _t_mix(y, a, h)
    b, x, h = _t_mix(b, x, h)
    y, c, h = _t_mix(y, c, h)
    return h


def jx_hash4(a, b, c, d):
    """crush_hash32_rjenkins1_4 over integer tensors (see jx_hash2)."""
    (a, b, c, d), h, x, y = _t_start(a, b, c, d)
    a, b, h = _t_mix(a, b, h)
    c, d, h = _t_mix(c, d, h)
    a, x, h = _t_mix(a, x, h)
    y, b, h = _t_mix(y, b, h)
    c, x, h = _t_mix(c, x, h)
    y, d, h = _t_mix(y, d, h)
    return h
