"""Hopper kernels of the byte-layout GF(2^8) codec — kernels K2 and K3.

Port of ``ceph_tpu/ops/gf_pallas.py``.  The module keeps the reference's
name so the port's layout mirrors it, but it holds hand-written CUDA
kernels for Hopper, not Pallas.

K2 replaces the reference's ``_kernel`` (launched by
``_bitplane_matmul_pallas``): for a GF(2) bit-matrix ``bitmat [8m, 8k]``
and byte rows ``data [..., k, L]`` it computes

    out = pack((bitmat @ unpack(data)) & 1)            [..., m, L] uint8

K3 replaces the reference's ``_fused_kernel`` (launched by
``fused_ragged_matmul``): for a ragged pool of staged blocks
``pool [G, k, T]`` it computes the same parity per block AND the zlib
crc32 of every data row and every parity row in the same pass.  The
reference returns the crcs as Pallas bit accumulators that its caller
packs; K3 returns the packed values (int64 tensors holding uint32, as
torch's uint32 has too few operators), the contract of
``ragged_fused.encode``.  With m = 0 it is the crc leg alone, which
``crc32_gf2.crc32_blocks`` launches for the wire's receive verify.

Dispatch is by the tensor's device and nothing else:

  * CUDA tensor: ``csrc/gf_bitplane.cu`` (K2) and ``csrc/ragged_fused.cu``
    (K3), whose headers say what bounds them on the card, built at first
    use by ops/_build.py and launched on the current stream.  Each 8x8
    block of ``bitmat`` is a GF(2)-linear map on bytes, so the wrapper
    builds the 256-entry byte tables T [m, k, 256] exactly on the host
    (``tables_host``), packs four output rows per 32-bit entry
    (``pack_tables``) and splits them by nibble into conflict-free
    16-entry tables (``nibble_tables``), cached on the card by content
    and device; both kernels XOR table lookups.  K3 splits its crc
    tables by nibble too; its crc walks each row 16 bytes per thread,
    and the host builds the GF(2) operators that carry each thread's
    and each warp's partial crc to the end of the row (``crc_tables``,
    ``warp_operators``).  ``bitplane_floor`` launches an empty kernel
    with K2's grid, the launch floor K2's time is measured against.  A
    refused launch raises; there is no fallback.
  * CPU tensor: the plain versions, ``gf_jax.bitplane_matmul`` (K2) and
    ``ragged_fused.fused_block_math`` (K3), which the tests hold
    bit-identical to ``ceph_tpu`` and ``chip_smoke.py`` holds the kernels
    to.

``launches`` / ``fused_launches`` count K2 / K3 launches (incremented
where the kernel is launched, nowhere else); ``plain_runs`` counts the
wrappers' trips through a plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math
import zlib

import numpy as np
import torch

from ..common import crcutil
from .gf_jax import bitplane_matmul as _bitplane_matmul_torch

launches = 0            # K2
fused_launches = 0      # K3
plain_runs = 0


# ------------------------------------------------------------ host tables --

def tables_host(bitmat) -> np.ndarray:
    """bitmat [8m, 8k] 0/1 -> T [m, k, 256] uint8 with
    T[i, j, v] = pack(B_ij . bits(v)), B_ij the 8x8 block of output
    symbol i and input symbol j (row 8i+a = bit a of output i, column
    8j+b = bit b of input j, as gf.gf8_bitmatrix lays them out)."""
    bm = np.asarray(bitmat).astype(np.int64) & 1
    R, C = bm.shape
    if R % 8 or C % 8:
        raise ValueError(f"bitmat shape {bm.shape} is not [8m, 8k]")
    m, k = R // 8, C // 8
    blocks = bm.reshape(m, 8, k, 8).transpose(0, 2, 1, 3)  # [m, k, a, b]
    vbits = (np.arange(256)[None, :] >> np.arange(8)[:, None]) & 1  # [b, v]
    outbits = np.einsum("ijab,bv->ijav", blocks, vbits) & 1
    weights = (1 << np.arange(8))[None, None, :, None]
    return (outbits * weights).sum(axis=2).astype(np.uint8)


def pack_tables(T: np.ndarray) -> np.ndarray:
    """T [m, k, 256] uint8 -> [ceil(m/4), k, 256] uint32: rows 4g..4g+3
    become bytes 0..3 of one entry (missing rows are zero)."""
    m, k, _ = T.shape
    G = (m + 3) // 4
    padded = np.zeros((4 * G, k, 256), dtype=np.uint32)
    padded[:m] = T
    p = padded.reshape(G, 4, k, 256)
    return (p[:, 0] | (p[:, 1] << 8) | (p[:, 2] << 16) |
            (p[:, 3] << 24)).astype(np.uint32)


def nibble_tables(bitmat) -> np.ndarray:
    """The tables K2 and K3 read: the packed byte tables [ceil(m/4), k,
    256] split into [ceil(m/4), k, 32] nibble tables (low nibble's 16
    entries, then the high nibble's): T[v] = T[v & 15] ^ T[v & 0xF0]."""
    packed = pack_tables(tables_host(bitmat))
    return np.concatenate([packed[..., :16], packed[..., ::16]], axis=-1)


@functools.lru_cache(maxsize=4096)
def _nibble_tables_device(key: bytes, R: int, C: int,
                          device: str) -> torch.Tensor:
    bm = np.frombuffer(key, dtype=np.uint8).reshape(R, C)
    return torch.as_tensor(np.ascontiguousarray(nibble_tables(bm))
                           .view(np.int32), device=device)


# ------------------------------------------------------------------ kernel --

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from . import _build
    lib = _build.load("gf_bitplane")
    lib.ceph_gf_bitplane.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p]
    lib.ceph_gf_bitplane.restype = ctypes.c_int
    lib.ceph_gf_bitplane_floor.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p]
    lib.ceph_gf_bitplane_floor.restype = ctypes.c_int
    lib.ceph_gf_bitplane_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ceph_gf_bitplane_smem_bytes.restype = ctypes.c_int
    lib.ceph_gf_bitplane_smem_limit.argtypes = []
    lib.ceph_gf_bitplane_smem_limit.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _smem(G: int, k: int, device: str):
    lib = _lib()
    with torch.cuda.device(device):
        return (lib.ceph_gf_bitplane_smem_bytes(G, k),
                lib.ceph_gf_bitplane_smem_limit())


def smem_bytes(m: int, k: int):
    """(bytes, limit): the shared memory one block of K2 takes for an
    [8m, 8k] bit-matrix (the first pass of at most four row groups), and
    the most a block may take on the current card (builds the kernel;
    asked once per shape and device)."""
    return _smem(min(4, (m + 3) // 4), k, "cuda")


@functools.lru_cache(maxsize=4096)
def _k2_tables(key: bytes, R: int, C: int, device: str) -> torch.Tensor:
    """The bit-matrix's nibble tables on the card, once its k data rows
    are known to fit a block's shared memory (cached by content and
    device: the ISA-L table-cache role, src/erasure-code/isa/
    ErasureCodeIsaTableCache.h:35)."""
    k = C // 8
    need, limit = _smem(1, k, device)
    if need > limit:
        raise ValueError(
            f"K2 holds {k} data rows of tables in {need} B of shared "
            f"memory per row group; a block takes at most {limit} B")
    return _nibble_tables_device(key, R, C, device)


def _launch(bm: np.ndarray, d3: torch.Tensor, m: int) -> torch.Tensor:
    """K2 on the card: data [B, k, L] -> [B, m, L]."""
    global launches
    dev = d3.device
    B, k, L = d3.shape
    out = torch.empty((B, m, L), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    tables = _k2_tables(bm.tobytes(), *bm.shape, str(dev))
    with torch.cuda.device(dev):
        rc = _lib().ceph_gf_bitplane(
            tables.data_ptr(), d3.data_ptr(), out.data_ptr(), B, k, m, L,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc} "
                           f"(data {tuple(d3.shape)}, m {m})")
    launches += 1
    return out


def bitplane_floor(m: int, data: torch.Tensor) -> None:
    """The launch floor of K2 for ``data`` [B, k, L] on the card and m
    output rows: an empty kernel launched with K2's grid, block and
    shared memory.  Not K2: it computes nothing and counts no launch."""
    B, k, L = data.shape
    with torch.cuda.device(data.device):
        rc = _lib().ceph_gf_bitplane_floor(
            B, k, m, L, torch.cuda.current_stream(data.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 floor launch failed: cudaError {rc} "
                           f"(data {tuple(data.shape)}, m {m})")


# ------------------------------------------------------------------ public --

def bitplane_matmul(bitmat, data: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matmul: bitmat [8m, 8k] 0/1 host array (from
    gf.gf8_bitmatrix, or any bit-matrix), data [..., k, L] uint8 ->
    [..., m, L] uint8 on ``data``'s device.  Leading axes flatten to one
    batch axis."""
    if not isinstance(data, torch.Tensor):
        raise TypeError("data must be a torch.Tensor")
    if data.dtype != torch.uint8:
        raise TypeError(f"data must be uint8, got {data.dtype}")
    if data.dim() < 2:
        raise ValueError(f"data must be [..., k, L], got {tuple(data.shape)}")
    bm = np.ascontiguousarray(bitmat, dtype=np.uint8)
    k, L = data.shape[-2], data.shape[-1]
    if bm.ndim != 2 or bm.shape[0] % 8 or bm.shape[1] != 8 * k:
        raise ValueError(f"bitmat shape {bm.shape} does not contract "
                         f"{k} data rows")
    m = bm.shape[0] // 8
    lead = tuple(data.shape[:-2])
    kind = data.device.type
    if kind == "cuda":
        if not data.is_contiguous():
            raise ValueError("K2 takes contiguous data")
        out = _launch(bm, data.view(math.prod(lead), k, L), m)
        return out.view(lead + (m, L))
    if kind == "cpu":
        global plain_runs
        plain_runs += 1
        return _bitplane_matmul_torch(torch.from_numpy(bm), data)
    raise ValueError(f"K2 has no kernel for device {data.device}")


# --------------------------------------------------------------------- K3 --
#
# K3's crc is zlib's register walk, linear over GF(2) once the affine
# constant crc32(0^T) is set aside: L(a || b) = Z^|b| L(a) ^ L(b), with L
# the walk from 0 and Z^n the 32x32 operator that advances a register
# through n zero bytes (crcutil._zero_matrix).  A block of K3_THREADS
# threads covers a row K3_CHUNK bytes at a time, thread t bytes
# [16t, 16t + 16) of each chunk, and every table below is GF(2)-linear in
# its index, so it is split into 16-entry nibble tables: a warp reading
# one of them hits at most 16 words in 16 banks (equal words broadcast),
# free of bank conflicts.

K3_THREADS = 256
K3_WARPS = K3_THREADS // 32
K3_CHUNK = 16 * K3_THREADS


def _byte_crc(v: int) -> int:
    """The walk from 0 over the single byte v (zlib's table entry)."""
    return zlib.crc32(bytes([v])) ^ zlib.crc32(b"\x00")


def _nibble_images(mat) -> np.ndarray:
    """[8, 16] uint32: out[j, n] = mat (n << 4j), so that
    mat v = XOR_j out[j, (v >> 4j) & 15]."""
    return np.array([[crcutil._matrix_times(mat, n << (4 * j))
                      for n in range(16)] for j in range(8)],
                    dtype=np.uint32)


def _gf2_inverse(cols):
    """The inverse of a 32x32 GF(2) matrix given as 32 column ints."""
    rows = [sum(((cols[i] >> r) & 1) << i for i in range(32)) |
            (1 << (32 + r)) for r in range(32)]
    for c in range(32):
        piv = next(r for r in range(c, 32) if (rows[r] >> c) & 1)
        rows[c], rows[piv] = rows[piv], rows[c]
        for r in range(32):
            if r != c and (rows[r] >> c) & 1:
                rows[r] ^= rows[c]
    return [sum(((rows[r] >> (32 + i)) & 1) << r for r in range(32))
            for i in range(32)]


@functools.lru_cache(maxsize=1)
def crc_tables() -> np.ndarray:
    """K3's fixed crc tables, one uint32 array in the kernel's order:

    * slicing [16, 2, 16]: [i, h, n] = Z^(15-i) L(n << 4h), so a thread's
      16 bytes x_0..x_15 walk from 0 to XOR_i of [i, 0, x_i & 15] and
      [i, 1, x_i >> 4] (32 independent lookups, no serial chain);
    * lanes [8, 16, 32]: lane l's operator Z^(16(31 - l)), nibble j of the
      register at [j, n, l]: it carries lane l's crc to the end of its
      warp's 512 bytes (lane-major, so a warp reads 32 banks);
    * roll [8, 16]: Z^K3_CHUNK, which carries a thread's running crc of a
      row longer than one chunk over the next chunk."""
    sl = np.array([[[crcutil._matrix_times(crcutil._zero_matrix(15 - i),
                                           _byte_crc(n << (4 * h)))
                     for n in range(16)] for h in range(2)]
                   for i in range(16)], dtype=np.uint32)
    lanes = np.stack([_nibble_images(crcutil._zero_matrix(16 * (31 - l)))
                      for l in range(32)], axis=-1)
    roll = _nibble_images(crcutil._zero_matrix(K3_CHUNK))
    return np.concatenate([sl.ravel(), lanes.ravel(), roll.ravel()])


@functools.lru_cache(maxsize=64)
def warp_operators(T: int) -> np.ndarray:
    """[32, 8] uint32: column i of warp w's operator at [i, w], the operator
    Z^(-z) Z^(512(7 - w)) that carries warp w's crc to the end of the
    zero-padded row (z = the padding past T to a whole number of chunks)
    and back to T; the XOR over warps is the row's linear crc."""
    z = -(-T // K3_CHUNK) * K3_CHUNK - T
    back = _gf2_inverse(crcutil._zero_matrix(z))
    out = np.zeros((32, K3_WARPS), dtype=np.uint32)
    for w in range(K3_WARPS):
        span = 512 * (K3_WARPS - 1 - w)
        out[:, w] = crcutil._matrix_mul(back, crcutil._zero_matrix(span))
    return out


@functools.lru_cache(maxsize=4)
def _crc_tables_device(device: str) -> torch.Tensor:
    return torch.as_tensor(crc_tables().view(np.int32), device=device)


@functools.lru_cache(maxsize=64)
def _warp_operators_device(T: int, device: str) -> torch.Tensor:
    return torch.as_tensor(warp_operators(T).view(np.int32), device=device)


@functools.lru_cache(maxsize=64)
def _zero_crc(T: int) -> int:
    """crc32 of T zero bytes: the affine constant of a T-byte crc."""
    return zlib.crc32(bytes(T))


@functools.lru_cache(maxsize=1)
def _fused_lib() -> ctypes.CDLL:
    from . import _build
    lib = _build.load("ragged_fused")
    lib.ceph_ragged_fused.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_uint, ctypes.c_void_p]
    lib.ceph_ragged_fused.restype = ctypes.c_int
    lib.ceph_ragged_fused_smem_bytes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    lib.ceph_ragged_fused_smem_bytes.restype = ctypes.c_int
    lib.ceph_ragged_fused_smem_limit.argtypes = []
    lib.ceph_ragged_fused_smem_limit.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _fused_smem(m: int, k: int, multi_chunk: bool, device: str):
    lib = _fused_lib()
    G = min(4, (m + 3) // 4)
    T = 2 * K3_CHUNK if multi_chunk else K3_CHUNK
    with torch.cuda.device(device):
        return (lib.ceph_ragged_fused_smem_bytes(G, k, min(m, 4 * G), T),
                lib.ceph_ragged_fused_smem_limit())


def fused_smem_bytes(m: int, k: int):
    """(bytes, limit): the shared memory one block of K3 takes in its
    first pass for k data rows, m parity rows and rows of one chunk, and
    the most a block may take on the current card (builds the kernel;
    asked once per shape)."""
    return _fused_smem(m, k, False, "cuda")


_NO_PARITY = np.zeros((0, 8), dtype=np.uint8)


def _launch_fused(bm: np.ndarray, pool: torch.Tensor):
    """K3 on the card: pool [G, k, T] -> (parity, data crcs, parity crcs).
    With m = 0 the parity and its crcs are empty views, not allocations."""
    global fused_launches
    G, k, T = pool.shape
    m = bm.shape[0] // 8
    dev = pool.device
    key = str(dev)
    dcrc = torch.empty((G, k), dtype=torch.int64, device=dev)
    tab_p = par_p = pcrc_p = None      # the crc leg reads no parity tables
    if m:
        parity = torch.empty((G, m, T), dtype=torch.uint8, device=dev)
        pcrc = torch.empty((G, m), dtype=torch.int64, device=dev)
        tab_p = _nibble_tables_device(bm.tobytes(), *bm.shape,
                                      key).data_ptr()
        par_p, pcrc_p = parity.data_ptr(), pcrc.data_ptr()
    else:
        parity, pcrc = pool[:, :0], dcrc[:, :0]
    if G == 0:
        return parity, dcrc, pcrc
    need, limit = _fused_smem(min(m, 4), k, T > K3_CHUNK, key)
    if need > limit:
        raise ValueError(
            f"K3 holds {k} data rows of tables and crc state in {need} B "
            f"of shared memory; a block takes at most {limit} B")
    ctab = _crc_tables_device(key)
    wops = _warp_operators_device(T, key)
    lib = _fused_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ceph_ragged_fused(
            tab_p, ctab.data_ptr(), wops.data_ptr(), pool.data_ptr(), par_p,
            dcrc.data_ptr(), pcrc_p, G, k, m, T, _zero_crc(T), stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {rc} "
                           f"(pool {tuple(pool.shape)}, m {m})")
    fused_launches += 1
    return parity, dcrc, pcrc


def fused_ragged_matmul(bitmat, pool: torch.Tensor):
    """The fused ragged traversal: bitmat [8m, 8k] 0/1 host array (m may
    be 0), pool [G, k, T] uint8 -> (parity [G, m, T] uint8, data crcs
    [G, k] int64, parity crcs [G, m] int64) on ``pool``'s device; each
    crc is the zlib crc32 of its T-byte row."""
    if not isinstance(pool, torch.Tensor):
        raise TypeError("pool must be a torch.Tensor")
    if pool.dtype != torch.uint8:
        raise TypeError(f"pool must be uint8, got {pool.dtype}")
    if pool.dim() != 3 or pool.shape[1] == 0 or pool.shape[2] == 0:
        raise ValueError(f"pool must be [G, k, T] with k, T >= 1, got "
                         f"{tuple(pool.shape)}")
    bm = np.ascontiguousarray(bitmat, dtype=np.uint8)
    G, k, T = pool.shape
    if bm.ndim != 2 or bm.shape[0] % 8 or bm.shape[1] != 8 * k:
        raise ValueError(f"bitmat shape {bm.shape} does not contract "
                         f"{k} data rows")
    if pool.device.type == "cuda":
        if not pool.is_contiguous():
            raise ValueError("K3 takes a contiguous pool")
        return _launch_fused(bm, pool)
    if pool.device.type == "cpu":
        global plain_runs
        plain_runs += 1
        from .ragged_fused import _crc_a8, fused_block_math
        A8, const = _crc_a8(T)
        return fused_block_math(torch.from_numpy(bm), torch.from_numpy(A8),
                                const, pool)
    raise ValueError(f"K3 has no kernel for device {pool.device}")


def crc_leg(blocks: torch.Tensor) -> torch.Tensor:
    """K3's crc leg alone (m = 0) over ``blocks`` [N, T] uint8 -> [N]
    int64 crc32 values: the receive verify's engine."""
    return fused_ragged_matmul(_NO_PARITY, blocks[:, None, :])[1][:, 0]
