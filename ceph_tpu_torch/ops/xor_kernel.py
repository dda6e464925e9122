"""Batched GF(2) region-XOR "matmul" — kernel K1 of the port.

Port of ``ceph_tpu/ops/xor_kernel.py``.  For the bit-sliced plane layout
of ops/gf2.py it computes

    out[b, r, :] = XOR_c ( planes[b, c, :] & masks[b or 0, r, c] )

a masked-XOR matrix product over int32 plane words (32 GF(2) lanes per
word).  The masks (0 / -1 words from gf2.bitmatrix_masks) are data, so
new erasure signatures reuse the same kernel, and a mask batch gives
every stripe of a recovery batch its own signature.

Dispatch is by the tensor's device and nothing else:

  * CUDA tensor: the hand-written Hopper kernel ``csrc/xor_matmul.cu``
    (its header says what bounds it on the card), built at first use by
    ops/_build.py and launched on the current stream.  A refused launch
    raises; there is no fallback.
  * CPU tensor: ``_combine_torch``, the plain PyTorch version — the same
    unrolled AND/XOR as the reference's ``_combine`` — which the tests
    hold bit-identical to ``ceph_tpu`` and ``chip_smoke.py`` holds the
    kernel to.

``launches`` counts kernel launches (incremented where the kernel is
launched, nowhere else); ``plain_runs`` counts the wrapper's trips
through the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch

from .. import resolve_device

launches = 0
plain_runs = 0
# the counts are bumped from every client thread that launches
_count_lock = threading.Lock()


# ------------------------------------------------------------- conversions --

def _u8_to_i32(x: torch.Tensor) -> torch.Tensor:
    """[..., P] uint8 -> [..., P//4] int32 (P % 4 == 0), a bit view."""
    if x.shape[-1] % 4:
        raise ValueError(f"plane length {x.shape[-1]} not divisible by 4")
    return x.contiguous().view(torch.int32)


def _i32_to_u8(x: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 -> [..., 4W] uint8 (inverse of _u8_to_i32)."""
    return x.contiguous().view(torch.uint8)


# -------------------------------------------------------------- contraction --

def _combine_torch(masks: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """masks [Bm, R, C] int32 (Bm = 1 or B), words [B, C, W] int32 ->
    [B, R, W] int32: the plain version, unrolled over the contraction
    axis like the reference's ``_combine``."""
    C = words.shape[1]
    acc = masks[:, :, 0:1] & words[:, 0:1, :]
    for c in range(1, C):
        acc ^= masks[:, :, c:c + 1] & words[:, c:c + 1, :]
    return acc


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from . import _build
    lib = _build.load("xor_matmul")
    lib.ceph_xor_matmul_w32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p]
    lib.ceph_xor_matmul_w32.restype = ctypes.c_int
    lib.ceph_xor_matmul_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ceph_xor_matmul_smem_bytes.restype = ctypes.c_int
    lib.ceph_xor_matmul_smem_limit.argtypes = []
    lib.ceph_xor_matmul_smem_limit.restype = ctypes.c_int
    return lib


def smem_bytes(R: int, C: int):
    """(bytes, limit): the shared memory K1 takes for an [R, C] mask
    matrix, and the most it takes (builds the kernel)."""
    lib = _lib()
    return (lib.ceph_xor_matmul_smem_bytes(R, C),
            lib.ceph_xor_matmul_smem_limit())


def _launch(m3: torch.Tensor, w3: torch.Tensor,
            per_batch: bool) -> torch.Tensor:
    """K1 on the card: masks [Bm, R, C], words [B, C, W] -> [B, R, W]."""
    global launches
    if m3.device != w3.device:
        raise ValueError(f"masks on {m3.device}, words on {w3.device}")
    if not (m3.is_contiguous() and w3.is_contiguous()):
        raise ValueError("K1 takes contiguous masks and words")
    B, C, W = w3.shape
    R = m3.shape[1]
    out = torch.empty((B, R, W), dtype=torch.int32, device=w3.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    need, limit = smem_bytes(R, C)
    if need > limit:
        raise ValueError(
            f"K1 holds the [{R}, {C}] masks in {need} B of shared memory; "
            f"it takes at most {limit} B")
    with torch.cuda.device(w3.device):
        stream = torch.cuda.current_stream(w3.device).cuda_stream
        rc = lib.ceph_xor_matmul_w32(
            m3.data_ptr(), w3.data_ptr(), out.data_ptr(), B,
            int(per_batch), R, C, W, stream)
    if rc != 0:
        raise RuntimeError(
            f"K1 launch failed: cudaError {rc} "
            f"(masks {tuple(m3.shape)}, words {tuple(w3.shape)})")
    with _count_lock:
        launches += 1
    return out


# ------------------------------------------------------------------ public --

def _as_tensor(x, dtype: torch.dtype, np_dtype, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if x.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {x.dtype}")
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x, dtype=np_dtype),
                           device=resolve_device(device))


def xor_matmul_w32(masks, words) -> torch.Tensor:
    """int32-domain entry: masks [R, C] or [..., R, C], words [..., C, W]
    int32 -> [..., R, W] int32 on the words' device.

    A leading batch axis on ``masks`` must match ``words``'s leading
    axes elementwise (per-stripe decode signatures).  NumPy words go to
    the package default device; NumPy masks go to the words' device.
    """
    words = _as_tensor(words, torch.int32, np.int32)
    if isinstance(masks, torch.Tensor) and masks.device != words.device:
        raise ValueError(f"masks on {masks.device}, words on {words.device}")
    masks = _as_tensor(masks, torch.int32, np.int32, words.device)
    lead = tuple(words.shape[:-2])
    C, W = words.shape[-2:]
    per_batch = masks.dim() > 2
    if per_batch and tuple(masks.shape[:-2]) != lead:
        raise ValueError(
            f"mask batch {tuple(masks.shape[:-2])} != data batch {lead}")
    if masks.shape[-1] != C:
        raise ValueError(
            f"masks contract {masks.shape[-1]} columns, data has {C} planes")
    B = math.prod(lead)
    R = masks.shape[-2]
    w3 = words.reshape(B, C, W)
    m3 = masks.reshape(B if per_batch else 1, R, C)
    if w3.device.type == "cuda":
        out = _launch(m3, w3, per_batch)
    elif w3.device.type == "cpu":
        global plain_runs
        plain_runs += 1
        out = _combine_torch(m3, w3)
    else:
        raise ValueError(f"K1 has no kernel for device {w3.device}")
    return out.reshape(lead + (R, W))


def xor_matmul(masks, planes) -> torch.Tensor:
    """uint8-domain entry: planes [..., C, P] uint8 (P % 4 == 0) ->
    [..., R, P] uint8 on the planes' device."""
    planes = _as_tensor(planes, torch.uint8, np.uint8)
    return _i32_to_u8(xor_matmul_w32(masks, _u8_to_i32(planes)))


@functools.lru_cache(maxsize=4096)
def _masks_device(key: bytes, R: int, C: int, device: str) -> torch.Tensor:
    from . import gf2
    bm = np.frombuffer(key, dtype=np.uint8).reshape(R, C)
    return torch.as_tensor(gf2.bitmatrix_masks(bm), device=device)


def masks_to_device(bitmat: np.ndarray, device=None) -> torch.Tensor:
    """Host GF(2) bit-matrix [R, C] 0/1 -> cached device mask operand
    [R, C] int32 (0 / -1), keyed by content and device (the ISA-L
    table-cache role, src/erasure-code/isa/ErasureCodeIsaTableCache.h:35)."""
    bm = np.ascontiguousarray(bitmat, dtype=np.uint8)
    return _masks_device(bm.tobytes(), *bm.shape,
                         str(resolve_device(device)))
