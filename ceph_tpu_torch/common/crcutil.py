"""CRC32 combine algebra + the one-pass integrity scan (ZeroWire).

The wire tier's remaining CPU cost (its trace decomposition) was
three separate ``zlib.crc32`` passes over every payload byte: the
frame crc on send, the verify on receive, and BlueStore's per-4KiB
blob csums — each ~0.8 GB/s, so ~3.6 ms CPU/MiB of pure re-scanning.
CRC32 is linear over GF(2), which makes all three derivable from ONE
scan: compute per-block sub-crcs once, then *combine* them —

    crc(a || b) == crc32_combine(crc(a), crc(b), len(b))

— where the combine is a 32x32 GF(2) matrix apply (zlib's
crc32_combine, src/common/crc32c.cc ceph_crc32c combine role).  The
sender combines sub-crcs into the frame crc, the receiver's single
verify scan RE-DERIVES the sub-crcs and hands them to the store as
trusted blob csums, and the store never scans payload bytes again.

The combine operator for a fixed length is cached as four 256-entry
byte tables, so a per-4KiB combine costs 4 lookups + 4 XORs instead
of a 4096-byte scan.

Every full-payload scan on the wire/store hot path reports here
(:func:`note_scan`) so ``bench_wire_async`` / ``scripts/check_wire.py``
can count crc passes per MiB falsifiably; avoidable buffer
materializations report through :func:`note_copy` the same way.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence, Tuple

_POLY = 0xEDB88320          # reflected CRC-32 (the zlib polynomial)
_M32 = 0xFFFFFFFF

# default sub-crc granularity: BlueStore's min_alloc, so wire sub-crcs
# land 1:1 as blob csums (cluster/bluestore.py _make_blob)
CSUM_BLOCK = 4096


def as_u8(buf) -> memoryview:
    """``buf`` as a flat uint8 memoryview — the one normalization
    every byte-addressed consumer on the zero-copy spine (wire
    framing, shm ring, store, crc kernels) shares."""
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    return mv


# ------------------------------------------------------ GF(2) matrices ---
# A 32x32 matrix over GF(2) is a list of 32 column ints: column i is
# the image of basis vector (1 << i).

def _matrix_times(mat: List[int], vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _matrix_mul(a: List[int], b: List[int]) -> List[int]:
    """a @ b (apply b first, then a)."""
    return [_matrix_times(a, col) for col in b]


def _matrix_square(mat: List[int]) -> List[int]:
    return _matrix_mul(mat, mat)


def _zero_matrix(length: int) -> List[int]:
    """Operator advancing a crc register through ``length`` zero BYTES
    (zlib crc32_combine's squaring walk, composed into one matrix)."""
    ident = [1 << i for i in range(32)]
    if length <= 0:
        return ident
    odd = [_POLY] + [1 << i for i in range(31)]   # one zero BIT
    even = _matrix_square(odd)                    # two bits
    odd = _matrix_square(even)                    # four bits
    acc = ident
    n = length
    while True:
        even = _matrix_square(odd)                # next power of two
        if n & 1:
            acc = _matrix_mul(even, acc)
        n >>= 1
        if not n:
            break
        odd = _matrix_square(even)
        if n & 1:
            acc = _matrix_mul(odd, acc)
        n >>= 1
        if not n:
            break
    return acc


def _tables_of(mat: List[int]) -> List[List[int]]:
    """Byte-indexed apply tables: mat @ v == t[0][v&255] ^ t[1][..] ^
    t[2][..] ^ t[3][v>>24] — the per-block combine drops from a 32-bit
    walk to 4 lookups."""
    out: List[List[int]] = []
    for k in range(4):
        t = [0] * 256
        for b in range(8):
            img = mat[8 * k + b]
            bit = 1 << b
            for v in range(bit, 256):
                if v & bit:
                    t[v] = t[v ^ bit] ^ img
        out.append(t)
    return out


_op_cache: Dict[int, List[List[int]]] = {}

# byte-apply tables are cached ONLY for lengths that repeat hot (the
# per-block combine in Csums.scan hoists its own via _zero_op); every
# other length — frame totals, buffer tails, arbitrary series parts —
# goes through the log(n) power-of-two matrix walk below, so a
# long-lived daemon serving many distinct payload sizes does not
# accrete a ~37 KB table per size
_OP_CACHE_MAX = 64

# _pow_mats[k] = operator advancing a crc through 2^k zero BYTES
# (immutable tuple swapped atomically: a racing rebuild recomputes
# identical values, last writer wins)
_pow_mats: Tuple[List[int], ...] = ()


def _zero_op(length: int) -> List[List[int]]:
    t = _op_cache.get(length)
    if t is None:
        t = _tables_of(_zero_matrix(length))
        if len(_op_cache) < _OP_CACHE_MAX:
            _op_cache[length] = t
    return t


def _pow_matrices(nbits: int) -> Tuple[List[int], ...]:
    global _pow_mats
    mats = _pow_mats
    if len(mats) < nbits:
        lst = list(mats)
        if not lst:
            one_bit = [_POLY] + [1 << i for i in range(31)]
            one_byte = _matrix_square(_matrix_square(
                _matrix_square(one_bit)))
            lst.append(one_byte)
        while len(lst) < nbits:
            lst.append(_matrix_square(lst[-1]))
        _pow_mats = mats = tuple(lst)
    return mats


def _advance_zeros(crc: int, length: int) -> int:
    """Advance ``crc`` through ``length`` zero bytes: one 32x32
    matrix-vector apply per set bit of ``length`` (bounded work,
    nothing cached per distinct length)."""
    mats = _pow_matrices(length.bit_length())
    k = 0
    while length:
        if length & 1:
            crc = _matrix_times(mats[k], crc)
        length >>= 1
        k += 1
    return crc


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc of the concatenation from the parts' crcs (zlib
    crc32_combine): advance ``crc1`` through ``len2`` zero bytes (a
    GF(2) matrix apply), then xor ``crc2``."""
    if len2 <= 0:
        return crc1 & _M32
    t = _op_cache.get(len2)
    if t is not None:
        v = (t[0][crc1 & 0xFF] ^ t[1][(crc1 >> 8) & 0xFF] ^
             t[2][(crc1 >> 16) & 0xFF] ^ t[3][(crc1 >> 24) & 0xFF])
    else:
        v = _advance_zeros(crc1 & _M32, len2)
    return (v ^ crc2) & _M32


def combine_series(crc: int, subs: Sequence[int],
                   lens: Sequence[int]) -> int:
    """Fold per-part sub-crcs onto a running crc in order."""
    for sub, ln in zip(subs, lens):
        crc = crc32_combine(crc, sub, ln)
    return crc


# ------------------------------------------------------------ hot flags ---
# observer-cached ZeroWire config flags (wire_one_pass / wire_zero_copy)
# shared by the wire framing and the store: the hot path pays one dict
# hit, never a layered-options lookup per frame/blob.

_flag_cache: Dict[str, bool] = {}


def flag(name: str) -> bool:
    v = _flag_cache.get(name)
    if v is None:
        from .options import config
        cfg = config()

        def _refresh(_n, val, _name=name):
            _flag_cache[_name] = bool(val)

        cfg.observe(name, _refresh)
        v = _flag_cache[name] = bool(cfg.get(name))
    return v


# ---------------------------------------------------------- scan counts ---
# hot-path integrity accounting, shared by wire.py / bluestore.py /
# shm_ring.py: every FULL payload scan (a zlib.crc32 walk over wire
# bytes) and every avoidable payload copy is counted here, which is
# what lets the bench and scripts/check_wire.py assert "one crc pass
# per byte" instead of taking it on faith.

_pc = None


def _counters():
    global _pc
    if _pc is None:
        from .perf_counters import perf
        _pc = perf("wire.zero")
    return _pc


def note_scan(nbytes: int, site: str) -> None:
    """One crc pass over ``nbytes`` payload bytes at ``site``
    (send / verify / store / client / shm)."""
    if nbytes <= 0:
        return
    pc = _counters()
    pc.inc("crc_scans")
    pc.inc("crc_scan_bytes", int(nbytes))
    pc.inc(f"scan_{site}_bytes", int(nbytes))


def note_copy(nbytes: int, site: str) -> None:
    """One avoidable payload materialization (legacy copy path)."""
    if nbytes <= 0:
        return
    pc = _counters()
    pc.inc("copies")
    pc.inc("copy_bytes", int(nbytes))
    pc.inc(f"copy_{site}_bytes", int(nbytes))


def note_trusted(nbytes: int) -> None:
    """Bytes whose blob csums arrived pre-verified (store scan saved)."""
    if nbytes > 0:
        _counters().inc("trusted_csum_bytes", int(nbytes))


def wire_zero_counters(cluster_dir: Optional[str] = None,
                       n_osds: int = 0,
                       include_local: bool = True) -> Dict[str, float]:
    """Summed ``perf('wire.zero')`` counters across this process
    (``include_local``) and every OSD daemon's asok — the one
    falsifiable sensor behind every crc-passes/copies-per-MiB
    assertion."""
    out: Dict[str, float] = {}

    def add(d):
        for k, v in (d or {}).items():
            if isinstance(v, (int, float)):
                out[k] = out.get(k, 0) + v

    if include_local:
        add(_counters().dump())
    if cluster_dir is not None:
        import os
        from .admin import admin_request
        for i in range(int(n_osds)):
            asok = os.path.join(cluster_dir, f"osd.{i}.asok")
            try:
                r = admin_request(asok, {"prefix": "perf dump"}) \
                    .get("result") or {}
            except (OSError, IOError):
                continue
            add(r.get("wire.zero"))
    return out


# --------------------------------------------------------------- Csums ---

class Csums:
    """Per-block sub-crcs of one payload buffer — the product of the
    single integrity scan, carried from wherever the bytes were first
    scanned (sender framing, receiver verify, device crc kernel) to
    every downstream consumer (frame crc, staging digest, BlueStore
    blob csums)."""

    __slots__ = ("block", "subs", "length", "combined")

    def __init__(self, block: int, subs: List[int], length: int,
                 combined: Optional[int] = None):
        self.block = int(block)
        self.subs = subs
        self.length = int(length)
        if combined is None:
            combined = 0
            off = 0
            for sub in subs:
                n = min(self.block, length - off)
                combined = crc32_combine(combined, sub, n)
                off += n
        self.combined = combined & _M32

    @classmethod
    def scan(cls, buf, block: int = CSUM_BLOCK,
             site: str = "send") -> "Csums":
        """THE one pass: per-block sub-crcs + the combined whole-buffer
        crc from a single walk over ``buf``.  The inner loop is the
        wire tier's hottest Python: combine tables and bound methods
        are hoisted so a full block costs one zlib call + 4 lookups."""
        mv = as_u8(buf)
        length = len(mv)
        subs: List[int] = []
        combined = 0
        full_end = length - (length % block)
        if full_end:
            crc32 = zlib.crc32
            append = subs.append
            t0, t1, t2, t3 = _zero_op(block)
            off = 0
            while off < full_end:
                sub = crc32(mv[off:off + block])
                append(sub)
                combined = (t0[combined & 0xFF] ^
                            t1[(combined >> 8) & 0xFF] ^
                            t2[(combined >> 16) & 0xFF] ^
                            t3[combined >> 24]) ^ sub
                off += block
        if full_end < length:
            sub = zlib.crc32(mv[full_end:])
            subs.append(sub)
            combined = crc32_combine(combined, sub,
                                     length - full_end)
        note_scan(length, site)
        return cls(block, subs, length, combined & _M32)

    def block_lens(self) -> List[int]:
        return [min(self.block, self.length - off)
                for off in range(0, self.length, self.block)]

    def __repr__(self) -> str:  # debug only
        return (f"Csums(block={self.block}, n={len(self.subs)}, "
                f"len={self.length}, crc={self.combined:#x})")


def verify_blocks(buf, block: int, want_combined: int,
                  site: str = "verify") -> Tuple[bool, Csums]:
    """Receiver-side single pass: scan ``buf`` per block, combine,
    compare against the sender's combined crc.  Returns (ok, csums) —
    on ok the csums are TRUSTED (they verified the payload) and flow
    to the store without another scan."""
    cs = Csums.scan(buf, block=block, site=site)
    return cs.combined == (want_combined & _M32), cs
