"""Hopper kernels of the byte-layout GF(2^8) codec — kernel K2 of the port.

Port of ``ceph_tpu/ops/gf_pallas.py``.  The module keeps the reference's
name so the port's layout mirrors it, but it holds hand-written CUDA
kernels for Hopper, not Pallas.  K2 replaces the reference's ``_kernel``
(launched by ``_bitplane_matmul_pallas``): for a GF(2) bit-matrix
``bitmat [8m, 8k]`` and byte rows ``data [..., k, L]`` it computes

    out = pack((bitmat @ unpack(data)) & 1)            [..., m, L] uint8

Dispatch is by the tensor's device and nothing else:

  * CUDA tensor: ``csrc/gf_bitplane.cu`` (its header says what bounds it
    on the card), built at first use by ops/_build.py and launched on the
    current stream.  Each 8x8 block of ``bitmat`` is a GF(2)-linear map on
    bytes, so the wrapper builds the 256-entry byte tables T [m, k, 256]
    exactly on the host (``tables_host``), packs four output rows per
    32-bit entry, caches them by content and device, and the kernel XORs
    table lookups.  A refused launch raises; there is no fallback.
  * CPU tensor: the plain version, ``gf_jax.bitplane_matmul`` (unpack,
    float32 product, repack), which the tests hold bit-identical to
    ``ceph_tpu`` and ``chip_smoke.py`` holds the kernel to.

``launches`` counts kernel launches (incremented where the kernel is
launched, nowhere else); ``plain_runs`` counts the wrapper's trips
through the plain version.  K3 (the fused ragged parity + crc kernel of
the wire tier, ``gf_pallas.fused_ragged_matmul`` in the reference) will
join this module in a later slice.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..common.perf_counters import perf as _perf
from .gf_jax import bitplane_matmul as _bitplane_matmul_torch

launches = 0
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
