"""ctypes bridge to the native C++ runtime built from ``native/*.cpp``.

Copy of ``ceph_tpu/native_bridge.py``; the one change is where the
library is built: ``build/native/libceph_tpu_native.so``, never under
``native/``.

Two surfaces:

  * ``NativeMapper`` — the compiled C++ CRUSH interpreter
    (native/crush_native.cpp), the fast host-side mapper.  It is the
    honest scalar-CPU baseline for the batched TPU mapper and the
    low-latency fallback for maps outside the vectorized subset (the
    role of crush_do_rule behind CrushWrapper::do_rule,
    src/crush/CrushWrapper.h:1581).
  * ``gf_matmul_regions`` — the SIMD GF(2^8) region codec
    (native/gf_native.cpp), the role ISA-L's ec_encode_data plays in the
    reference (src/erasure-code/isa/ErasureCodeIsa.cc:129) and the
    honest local CPU throughput baseline for the TPU EC kernels.

The shared object is (re)built on demand by ``ensure_built``; loading is
lazy so pure-Python paths never require a toolchain.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

from .placement import lntable
from .placement.crush_map import (
    BUCKET_LIST, BUCKET_STRAW, BUCKET_TREE, ITEM_NONE, CrushMap)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO, "native")
_BUILD_DIR = os.path.join(_REPO, "build", "native")
_SO = os.path.join(_BUILD_DIR, "libceph_tpu_native.so")
_SRCS = ("crush_native.cpp", "gf_native.cpp", "msgqueue.cpp",
         "allocator_native.cpp")
# native/Makefile's flags; -march=native only where the compiler has AVX2
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)


class NativeUnavailable(RuntimeError):
    """The native library could not be built or loaded."""


def _native_arch(cxx: str) -> list:
    proc = subprocess.run([cxx, "-march=native", "-dM", "-E", "-x", "c++",
                           os.devnull], capture_output=True, text=True,
                          timeout=60)
    return ["-march=native"] if "__AVX2__" in proc.stdout else []


def ensure_built(force: bool = False) -> str:
    """Build the shared object if missing or stale; returns its path.

    Compiles ``native/*.cpp`` with the flags of ``native/Makefile`` into
    ``build/native/`` (listed in ``.gitignore``).  Nothing is written
    under ``native/``: the library there is the reference package's."""
    srcs = [os.path.join(_NATIVE_DIR, f) for f in _SRCS + ("Makefile",)]
    stale = (not os.path.exists(_SO) or
             any(os.path.getmtime(s) > os.path.getmtime(_SO)
                 for s in srcs if os.path.exists(s)))
    if force or stale:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        cxx = os.environ.get("CXX", "g++")
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = [cxx, *_CXXFLAGS, *_native_arch(cxx), "-shared", "-o", tmp,
               *(os.path.join(_NATIVE_DIR, f) for f in _SRCS)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except OSError as e:
            raise NativeUnavailable(f"native build failed: {e}") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise NativeUnavailable(
                f"native build failed:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, _SO)   # atomic: a concurrent loader never sees half
    return _SO


def _i32p(a: Optional[np.ndarray]):
    if a is None:
        return None
    return a.ctypes.data_as(_I32P)


def lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            try:
                so = ensure_built()
                _LIB = ctypes.CDLL(so)
            except OSError as e:
                raise NativeUnavailable(str(e)) from e
            _LIB.ceph_tpu_do_rule_batch.restype = ctypes.c_int
            _LIB.ceph_tpu_do_rule_batch.argtypes = [
                ctypes.c_int32, ctypes.c_int32,          # n_buckets, max_size
                _I32P, _I32P, _I32P, _I32P, _I32P,       # items..algs
                _I32P, _I32P, _I32P, _I32P,              # aux tables
                _I64P, ctypes.c_int32,                   # ln_table, max_dev
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # tunables
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                _I32P, ctypes.c_int32,                   # steps, n_steps
                _I32P, _I32P, ctypes.c_int32,            # choose_args
                _U32P, ctypes.c_int64, ctypes.c_int32,   # xs, n, result_max
                _I32P, _I32P]                            # weights, results
            _LIB.ceph_tpu_gf_matmul_regions.restype = ctypes.c_int
            _LIB.ceph_tpu_gf_matmul_regions.argtypes = [
                _U8P, ctypes.c_int32, ctypes.c_int32, _U8P, _U8P,
                ctypes.c_int64]
            _LIB.ceph_tpu_gf_region_mul_xor.restype = None
            _LIB.ceph_tpu_gf_region_mul_xor.argtypes = [
                _U8P, _U8P, ctypes.c_uint8, ctypes.c_int64]
            _LIB.ceph_tpu_gf2_xor_regions.restype = ctypes.c_int
            _LIB.ceph_tpu_gf2_xor_regions.argtypes = [
                _U8P, ctypes.c_int32, ctypes.c_int32, _U8P, _U8P,
                ctypes.c_int64]
            _U64P = ctypes.POINTER(ctypes.c_uint64)
            _LIB.ceph_tpu_alloc_init.restype = None
            _LIB.ceph_tpu_alloc_init.argtypes = [_U64P, ctypes.c_int64]
            _LIB.ceph_tpu_alloc_count_free.restype = ctypes.c_int64
            _LIB.ceph_tpu_alloc_count_free.argtypes = [
                _U64P, ctypes.c_int64]
            _LIB.ceph_tpu_alloc_mark.restype = ctypes.c_int
            _LIB.ceph_tpu_alloc_mark.argtypes = [
                _U64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
            _LIB.ceph_tpu_alloc_release.restype = ctypes.c_int
            _LIB.ceph_tpu_alloc_release.argtypes = [
                _U64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
            _LIB.ceph_tpu_alloc_runs.restype = ctypes.c_int
            _LIB.ceph_tpu_alloc_runs.argtypes = [
                _U64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                _I64P, ctypes.c_int]
            _LIB.ceph_tpu_has_avx2.restype = ctypes.c_int
            _LIB.ceph_tpu_hash2.restype = ctypes.c_uint32
            _LIB.ceph_tpu_hash2.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
            _LIB.ceph_tpu_hash3.restype = ctypes.c_uint32
            _LIB.ceph_tpu_hash3.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                            ctypes.c_uint32]
        return _LIB


def has_avx2() -> bool:
    return bool(lib().ceph_tpu_has_avx2())


# ------------------------------------------------------------------ CRUSH ---

class NativeMapper:
    """Flatten a CrushMap into the dense MapView arrays once, then run
    batched do_rule sweeps through the C++ interpreter."""

    def __init__(self, cmap: CrushMap, choose_args_key: object = None):
        lib()   # fail fast if unbuildable
        self.cmap = cmap
        B = cmap.max_buckets
        # node_weights stride in the C ABI is 2*max_size: widen max_size so
        # every TREE bucket's num_nodes (which can exceed 2*size for
        # non-power-of-two sizes) still fits.
        S = max((b.size for b in cmap.buckets if b is not None), default=1)
        for b in cmap.buckets:
            if b is not None and b.alg == BUCKET_TREE and b.num_nodes:
                S = max(S, (b.num_nodes + 1) // 2)
        S = max(S, 1)
        self.items = np.zeros((B, S), dtype=np.int32)
        self.weights = np.zeros((B, S), dtype=np.int32)
        self.sizes = np.zeros(B, dtype=np.int32)
        self.types = np.zeros(B, dtype=np.int32)
        self.algs = np.zeros(B, dtype=np.int32)
        self.sum_weights = np.zeros((B, S), dtype=np.int32)
        self.straws = np.zeros((B, S), dtype=np.int32)
        self.node_weights = np.zeros((B, 2 * S), dtype=np.int32)
        self.num_nodes = np.zeros(B, dtype=np.int32)
        for i, b in enumerate(cmap.buckets):
            if b is None:
                continue
            n = b.size
            self.items[i, :n] = b.items
            if b.weights:
                w = ([b.weights[0]] * n if len(b.weights) == 1 and n > 1
                     else b.weights[:n])
                self.weights[i, :len(w)] = w
            self.sizes[i] = n
            self.types[i] = b.type
            self.algs[i] = b.alg
            # derived tables are u32 (wrapped in finalize_derived);
            # reinterpret as i32 for the C ABI, which zero-extends back
            if b.alg == BUCKET_LIST and b.sum_weights:
                self.sum_weights[i, :n] = np.asarray(
                    b.sum_weights, dtype=np.uint32).view(np.int32)
            if b.alg == BUCKET_STRAW and b.straws:
                self.straws[i, :n] = np.asarray(
                    b.straws, dtype=np.uint32).view(np.int32)
            if b.alg == BUCKET_TREE and b.node_weights:
                self.node_weights[i, :len(b.node_weights)] = np.asarray(
                    b.node_weights, dtype=np.uint32).view(np.int32)
                self.num_nodes[i] = b.num_nodes
        self.max_size = S
        self.ln_table = np.ascontiguousarray(
            lntable.crush_ln_lut(), dtype=np.int64)
        # choose_args → flattened [B, P, S] weight sets / [B, S] ids
        self.arg_weight_sets: Optional[np.ndarray] = None
        self.arg_ids: Optional[np.ndarray] = None
        self.n_positions = 0
        if choose_args_key is not None:
            args = cmap.choose_args.get(choose_args_key)
            if args:
                P = max((len(a.weight_set) for a in args
                         if a is not None and a.weight_set), default=0)
                if P:
                    ws = np.zeros((B, P, S), dtype=np.int32)
                    for i, a in enumerate(args[:B]):
                        src = (a.weight_set if a is not None and a.weight_set
                               else None)
                        for p in range(P):
                            row = (src[min(p, len(src) - 1)] if src
                                   else (cmap.buckets[i].weights
                                         if cmap.buckets[i] else []))
                            ws[i, p, :len(row)] = row
                    self.arg_weight_sets = ws
                    self.n_positions = P
                if any(a is not None and a.ids for a in args):
                    ids = np.array(self.items, copy=True)
                    for i, a in enumerate(args[:B]):
                        if a is not None and a.ids:
                            ids[i, :len(a.ids)] = a.ids
                    self.arg_ids = ids

    def map_batch(self, ruleno: int, xs, result_max: int,
                  weights: Sequence[int]) -> np.ndarray:
        rule = self.cmap.rules[ruleno]
        if rule is None:
            raise ValueError(f"no rule {ruleno}")
        steps = np.asarray([list(s) for s in rule.steps],
                           dtype=np.int32).reshape(-1)
        xs = np.ascontiguousarray(np.asarray(xs, dtype=np.uint32))
        dev_w = np.zeros(self.cmap.max_devices, dtype=np.int32)
        w_in = np.asarray(list(weights), dtype=np.int64)
        dev_w[:len(w_in)] = np.clip(w_in, 0, 0x10000)
        results = np.empty((len(xs), result_max), dtype=np.int32)
        t = self.cmap.tunables
        rc = lib().ceph_tpu_do_rule_batch(
            np.int32(self.cmap.max_buckets), np.int32(self.max_size),
            _i32p(self.items), _i32p(self.weights), _i32p(self.sizes),
            _i32p(self.types), _i32p(self.algs), _i32p(self.sum_weights),
            _i32p(self.straws), _i32p(self.node_weights),
            _i32p(self.num_nodes), self.ln_table.ctypes.data_as(_I64P),
            np.int32(self.cmap.max_devices),
            np.int32(t.choose_local_tries),
            np.int32(t.choose_local_fallback_tries),
            np.int32(t.choose_total_tries),
            np.int32(t.chooseleaf_descend_once),
            np.int32(t.chooseleaf_vary_r),
            np.int32(t.chooseleaf_stable),
            _i32p(steps), np.int32(len(rule.steps)),
            _i32p(self.arg_weight_sets), _i32p(self.arg_ids),
            np.int32(self.n_positions),
            xs.ctypes.data_as(_U32P), np.int64(len(xs)),
            np.int32(result_max), _i32p(dev_w),
            results.ctypes.data_as(_I32P))
        if rc != 0:
            raise RuntimeError(f"native do_rule_batch rc={rc}")
        return results


# --------------------------------------------------------------------- GF ---

def gf_matmul_regions(matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """out[m, chunk] = matrix[m, k] ∘ data[k, chunk] over GF(2^8)."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    m, k = matrix.shape
    assert data.shape[0] == k, (matrix.shape, data.shape)
    chunk = data.shape[1]
    out = np.empty((m, chunk), dtype=np.uint8)
    lib().ceph_tpu_gf_matmul_regions(
        matrix.ctypes.data_as(_U8P), np.int32(m), np.int32(k),
        data.ctypes.data_as(_U8P), out.ctypes.data_as(_U8P),
        np.int64(chunk))
    return out


def gf_matmul_regions_batch(matrix: np.ndarray,
                            data: np.ndarray) -> np.ndarray:
    """Batched: data [B, k, chunk] → [B, m, chunk]."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    B, k, chunk = data.shape
    m = matrix.shape[0]
    out = np.empty((B, m, chunk), dtype=np.uint8)
    fn = lib().ceph_tpu_gf_matmul_regions
    mp = matrix.ctypes.data_as(_U8P)
    for i in range(B):
        fn(mp, np.int32(m), np.int32(k), data[i].ctypes.data_as(_U8P),
           out[i].ctypes.data_as(_U8P), np.int64(chunk))
    return out


def region_mul_xor(dst: np.ndarray, src: np.ndarray, c: int) -> None:
    """dst ^= c * src in place (GF(2^8))."""
    assert dst.dtype == np.uint8 and src.dtype == np.uint8
    assert dst.flags.c_contiguous and src.flags.c_contiguous
    lib().ceph_tpu_gf_region_mul_xor(
        dst.ctypes.data_as(_U8P), src.ctypes.data_as(_U8P),
        np.uint8(c), np.int64(dst.size))


def gf2_xor_regions(bitmat: np.ndarray, planes: np.ndarray) -> np.ndarray:
    """AVX2 bit-sliced codec: out[R, P] planes = bitmat [R, C] ∘
    planes [C, P] over GF(2) (region XOR — jerasure schedule role)."""
    bitmat = np.ascontiguousarray(bitmat, dtype=np.uint8)
    planes = np.ascontiguousarray(planes, dtype=np.uint8)
    R, C = bitmat.shape
    if planes.shape[0] != C:
        raise ValueError(
            f"bitmat {bitmat.shape} needs {C} planes, got {planes.shape}")
    P = planes.shape[1]
    out = np.empty((R, P), dtype=np.uint8)
    lib().ceph_tpu_gf2_xor_regions(
        bitmat.ctypes.data_as(_U8P), np.int32(R), np.int32(C),
        planes.ctypes.data_as(_U8P), out.ctypes.data_as(_U8P), np.int64(P))
    return out


# ---------------------------------------------------------------- allocator --

_U64PTR = ctypes.POINTER(ctypes.c_uint64)


class AllocatorError(RuntimeError):
    pass


class BitmapAllocator:
    """Block-space allocator over a numpy uint64 bitmap (the BlueStore
    Allocator family role — src/os/bluestore/BitmapAllocator.h).  The
    bitmap itself is plain numpy so the owning store can rebuild it from
    object metadata at mount (the post-Pacific BlueStore NCB freelist
    stance: no persisted freelist, recover allocations from onodes).

    A pure-numpy fallback keeps the store importable without a
    toolchain; the native path is the default.
    """

    def __init__(self, n_blocks: int, use_native: bool = True):
        if n_blocks <= 0:
            raise ValueError("n_blocks must be positive")
        self.n_blocks = int(n_blocks)
        self._words = np.zeros((self.n_blocks + 63) // 64, dtype=np.uint64)
        self._native = False
        if use_native:
            try:
                lib().ceph_tpu_alloc_init(
                    self._words.ctypes.data_as(_U64PTR),
                    np.int64(self.n_blocks))
                self._native = True
            except NativeUnavailable:
                pass
        if not self._native:
            rem = self.n_blocks % 64
            if rem:
                self._words[-1] = np.uint64(
                    (0xFFFFFFFFFFFFFFFF << rem) & 0xFFFFFFFFFFFFFFFF)

    @property
    def free_blocks(self) -> int:
        if self._native:
            return int(lib().ceph_tpu_alloc_count_free(
                self._words.ctypes.data_as(_U64PTR),
                np.int64(self.n_blocks)))
        used = int(np.unpackbits(
            self._words.view(np.uint8)).sum())
        return self._words.size * 64 - used

    def _bits(self) -> np.ndarray:
        """Bit array [n_words*64], little-endian bit order per word."""
        by = self._words.view(np.uint8)
        return np.unpackbits(by, bitorder="little")

    def allocate(self, want: int, hint: int = 0):
        """Allocate `want` blocks; returns list of (start, len) runs.
        Raises AllocatorError when space is insufficient (no partial
        allocation escapes)."""
        if want <= 0:
            return []
        max_runs = max(16, min(4096, int(want)))
        if self._native:
            out = np.empty(2 * max_runs, dtype=np.int64)
            rc = lib().ceph_tpu_alloc_runs(
                self._words.ctypes.data_as(_U64PTR),
                np.int64(self.n_blocks), np.int64(want), np.int64(hint),
                out.ctypes.data_as(_I64P), np.int32(max_runs))
            if rc >= 0:
                return [(int(out[2 * i]), int(out[2 * i + 1]))
                        for i in range(rc)]
            if self.free_blocks < want:
                raise AllocatorError(
                    f"cannot allocate {want} blocks "
                    f"({self.free_blocks} free)")
            # enough space but the run table overflowed (severe
            # fragmentation): the vectorized path below has no run cap
        # numpy fallback: greedy first-fit over free runs
        bits = self._bits()[:self.n_blocks]
        free_idx = np.flatnonzero(bits == 0)
        if len(free_idx) < want:
            raise AllocatorError(
                f"cannot allocate {want} blocks ({len(free_idx)} free)")
        order = np.concatenate([free_idx[free_idx >= hint],
                                free_idx[free_idx < hint]])
        take = np.sort(order[:want])
        runs = []
        run_start = prev = int(take[0])
        for b in take[1:]:
            b = int(b)
            if b == prev + 1:
                prev = b
                continue
            runs.append((run_start, prev - run_start + 1))
            run_start = prev = b
        runs.append((run_start, prev - run_start + 1))
        for s, ln in runs:
            self.mark(s, ln)
        return runs

    def mark(self, start: int, length: int) -> None:
        """Mark [start, start+len) allocated; AllocatorError on overlap
        (mount-time rebuild uses this to detect double-allocation)."""
        if self._native:
            rc = lib().ceph_tpu_alloc_mark(
                self._words.ctypes.data_as(_U64PTR),
                np.int64(self.n_blocks), np.int64(start),
                np.int64(length))
            if rc != 0:
                raise AllocatorError(
                    f"mark [{start},+{length}): overlap/out-of-range")
            return
        if start < 0 or length <= 0 or start + length > self.n_blocks:
            raise AllocatorError(f"mark [{start},+{length}): out of range")
        for b in range(start, start + length):
            w, bit = b // 64, b % 64
            m = np.uint64(1 << bit)
            if self._words[w] & m:
                raise AllocatorError(f"mark {b}: already allocated")
            self._words[w] |= m

    def release(self, start: int, length: int) -> None:
        if self._native:
            rc = lib().ceph_tpu_alloc_release(
                self._words.ctypes.data_as(_U64PTR),
                np.int64(self.n_blocks), np.int64(start),
                np.int64(length))
            if rc != 0:
                raise AllocatorError(
                    f"release [{start},+{length}): double free/range")
            return
        if start < 0 or length <= 0 or start + length > self.n_blocks:
            raise AllocatorError(
                f"release [{start},+{length}): out of range")
        for b in range(start, start + length):
            w, bit = b // 64, b % 64
            m = np.uint64(1 << bit)
            if not (self._words[w] & m):
                raise AllocatorError(f"release {b}: double free")
            self._words[w] &= ~m


def gf2_xor_regions_batch(bitmat: np.ndarray,
                          planes: np.ndarray) -> np.ndarray:
    """Batched bit-sliced codec: planes [B, C, P] → [B, R, P]."""
    bitmat = np.ascontiguousarray(bitmat, dtype=np.uint8)
    planes = np.ascontiguousarray(planes, dtype=np.uint8)
    B, C, P = planes.shape
    R = bitmat.shape[0]
    if bitmat.shape[1] != C:
        raise ValueError(
            f"bitmat {bitmat.shape} needs {bitmat.shape[1]} planes, "
            f"got {C}")
    out = np.empty((B, R, P), dtype=np.uint8)
    fn = lib().ceph_tpu_gf2_xor_regions
    bp = bitmat.ctypes.data_as(_U8P)
    for i in range(B):
        fn(bp, np.int32(R), np.int32(C), planes[i].ctypes.data_as(_U8P),
           out[i].ctypes.data_as(_U8P), np.int64(P))
    return out
