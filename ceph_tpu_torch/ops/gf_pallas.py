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
    (``tables_host``), packs four output rows per 32-bit entry, caches
    them by content and device, and the kernels XOR table lookups.  K3's
    crc is zlib's table walk split over the 32 lanes of a warp; the
    wrapper hands each lane the GF(2) operator that carries its partial
    crc to the end of the row (``lane_operators``).  A refused launch
    raises; there is no fallback.
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
from ..common.perf_counters import perf as _perf
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


@functools.lru_cache(maxsize=4096)
def _tables_device(key: bytes, R: int, C: int, device: str) -> torch.Tensor:
    bm = np.frombuffer(key, dtype=np.uint8).reshape(R, C)
    packed = pack_tables(tables_host(bm))
    return torch.as_tensor(packed.view(np.int32), device=device)


def tables_to_device(bm: np.ndarray, device) -> torch.Tensor:
    """Cached packed K2 tables [ceil(m/4), k, 256] (int32 words) on
    ``device`` for a host bit-matrix, keyed by content and device (the
    ISA-L table-cache role, src/erasure-code/isa/
    ErasureCodeIsaTableCache.h:35)."""
    return _tables_device(bm.tobytes(), *bm.shape, str(torch.device(device)))


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
    lib.ceph_gf_bitplane_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ceph_gf_bitplane_smem_bytes.restype = ctypes.c_int
    lib.ceph_gf_bitplane_smem_limit.argtypes = []
    lib.ceph_gf_bitplane_smem_limit.restype = ctypes.c_int
    return lib


def smem_bytes(m: int, k: int):
    """(bytes, limit): the shared memory one block of K2 takes for an
    [8m, 8k] bit-matrix (the first pass of at most four row groups), and
    the most a block may take on the current card (builds the kernel)."""
    lib = _lib()
    G = min(4, (m + 3) // 4)
    return (lib.ceph_gf_bitplane_smem_bytes(G, k),
            lib.ceph_gf_bitplane_smem_limit())


def _launch(tables: torch.Tensor, d3: torch.Tensor, m: int) -> torch.Tensor:
    """K2 on the card: packed tables, data [B, k, L] -> [B, m, L]."""
    global launches
    if tables.device != d3.device:
        raise ValueError(f"tables on {tables.device}, data on {d3.device}")
    B, k, L = d3.shape
    out = torch.empty((B, m, L), dtype=torch.uint8, device=d3.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(d3.device):
        need, limit = smem_bytes(1, k)
        if need > limit:
            raise ValueError(
                f"K2 holds {k} data rows of tables in {need} B of shared "
                f"memory per row group; a block takes at most {limit} B")
        stream = torch.cuda.current_stream(d3.device).cuda_stream
        rc = lib.ceph_gf_bitplane(tables.data_ptr(), d3.data_ptr(),
                                  out.data_ptr(), B, k, m, L, stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc} "
                           f"(data {tuple(d3.shape)}, m {m})")
    launches += 1
    _perf("gf_pallas").inc("launches")
    return out


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
    if data.device.type == "cuda":
        if not data.is_contiguous():
            raise ValueError("K2 takes contiguous data")
        d3 = data.view(math.prod(lead), k, L)
        out = _launch(tables_to_device(bm, data.device), d3, m)
        return out.reshape(lead + (m, L))
    if data.device.type == "cpu":
        global plain_runs
        plain_runs += 1
        return _bitplane_matmul_torch(torch.from_numpy(bm), data)
    raise ValueError(f"K2 has no kernel for device {data.device}")


# --------------------------------------------------------------------- K3 --

def lane_operators(T: int) -> np.ndarray:
    """[32, 32] uint32: column i of lane p's operator Z^(T - end_p) at
    [i, p], where lane p of K3's warp walks columns [pS, pS + S) of a
    T-byte row (S = ceil(T/32)), end_p is where its segment ends, and Z^n
    advances a crc register through n zero bytes (crcutil._zero_matrix).
    XOR over lanes of Z^(T - end_p)(partial_p) is the row's linear crc."""
    S = -(-T // 32)
    out = np.zeros((32, 32), dtype=np.uint32)
    for p in range(32):
        end = min(min(p * S, T) + S, T)
        out[:, p] = crcutil._zero_matrix(T - end)
    return out


@functools.lru_cache(maxsize=64)
def _lane_operators_device(T: int, device: str) -> torch.Tensor:
    return torch.as_tensor(lane_operators(T).view(np.int32), device=device)


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
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p]
    lib.ceph_ragged_fused.restype = ctypes.c_int
    lib.ceph_ragged_fused_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_int]
    lib.ceph_ragged_fused_smem_bytes.restype = ctypes.c_int
    lib.ceph_ragged_fused_smem_limit.argtypes = []
    lib.ceph_ragged_fused_smem_limit.restype = ctypes.c_int
    return lib


def fused_smem_bytes(m: int, k: int):
    """(bytes, limit): the shared memory one block of K3 takes in its
    first pass for k data rows and m parity rows, and the most a block
    may take on the current card (builds the kernel)."""
    lib = _fused_lib()
    G = min(4, (m + 3) // 4)
    return (lib.ceph_ragged_fused_smem_bytes(G, k, min(m, 4 * G)),
            lib.ceph_ragged_fused_smem_limit())


def _launch_fused(bm: np.ndarray, pool: torch.Tensor):
    """K3 on the card: pool [G, k, T] -> (parity, data crcs, parity crcs)."""
    global fused_launches
    G, k, T = pool.shape
    m = bm.shape[0] // 8
    dev = pool.device
    parity = torch.empty((G, m, T), dtype=torch.uint8, device=dev)
    dcrc = torch.empty((G, k), dtype=torch.int32, device=dev)
    pcrc = torch.empty((G, m), dtype=torch.int32, device=dev)
    if G == 0:
        return parity, dcrc.long(), pcrc.long()
    lib = _fused_lib()
    # m = 0 (the crc leg alone) reads no tables: any valid pointer does
    tables = tables_to_device(bm, dev) if m else dcrc
    lanes = _lane_operators_device(T, str(dev))
    with torch.cuda.device(dev):
        need, limit = fused_smem_bytes(min(m, 4), k)
        if need > limit:
            raise ValueError(
                f"K3 holds {k} data rows of tables and crc registers in "
                f"{need} B of shared memory; a block takes at most {limit} B")
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ceph_ragged_fused(
            tables.data_ptr(), lanes.data_ptr(), pool.data_ptr(),
            parity.data_ptr(), dcrc.data_ptr(), pcrc.data_ptr(), G, k, m, T,
            _zero_crc(T), stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {rc} "
                           f"(pool {tuple(pool.shape)}, m {m})")
    fused_launches += 1
    _perf("gf_pallas").inc("fused_launches")
    mask = 0xFFFFFFFF
    return parity, dcrc.long() & mask, pcrc.long() & mask


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
