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
    ops/_build.py and launched on the current stream under a launch
    plan this module chooses in Python (``plan``: tile, row groups,
    stages, persistent grid), cached per shape and card.  A refused
    launch raises; there is no fallback.
  * CPU tensor: ``_combine_torch``, the plain PyTorch version — the same
    unrolled AND/XOR as the reference's ``_combine`` — which the tests
    hold bit-identical to ``ceph_tpu`` and ``chip_smoke.py`` holds the
    kernel to.

``launches`` counts kernel launches (incremented where the kernel is
launched, nowhere else); ``plain_runs`` counts the wrapper's trips
through the plain version.  ``matmul_floor`` launches an empty kernel
at K1's grid and shared memory (its launch floor) and counts nothing.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
import threading
from typing import NamedTuple

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


# ------------------------------------------------------------ launch plan --

THREADS = 128           # a block: four warps (csrc/xor_matmul.cu kThreads)
SM_SMEM = 233_472       # shared memory of one H100 SM; 1 KiB reserved a block
NARROW_STAGE = 48 << 10  # a slab at most this large is staged whole
WIDE_STAGE = 32 << 10    # else the ring's stages hold this much
RING = 2                 # stages in the ring when a slab is staged in chunks
BAR_INTS = 16            # the ring's mbarriers (csrc kBarInts)


class Plan(NamedTuple):
    """How K1 launches for one operand shape (csrc/xor_matmul.cu's
    header): ``vec`` words a copy and a thread column (4, or 1 on the
    scalar path), ``rg`` output rows a register group, ``ctw`` warps
    across a tile (the other 4 // ctw warps split the contraction),
    ``cc`` planes a stage, ``stages`` in the ring, ``grid`` blocks (one
    a work item: B x tiles x groups) and ``smem`` bytes of dynamic
    shared memory a block."""
    vec: int
    rg: int
    ctw: int
    cc: int
    stages: int
    grid: int
    tiles: int
    groups: int
    smem: int

    @property
    def ks(self) -> int:
        return 4 // self.ctw

    @property
    def tile_words(self) -> int:
        return self.ctw * 32 * self.vec

    def args(self):
        return (self.vec, self.rg, self.ctw, self.cc, self.stages)


def row_group(R: int) -> int:
    """Rows a register group holds: the smallest of 8, 16, 24, 32 that
    covers R, else 32 (more rows take more groups)."""
    return next((g for g in (8, 16, 24) if g >= R), 32)


def smem_needed(R: int, C: int, vec: int, rg: int, ctw: int, cc: int,
                stages: int) -> int:
    """Dynamic shared memory of one block: the ring's mbarriers, the
    item's masks [C][rg], the ring of [cc, tile] stages, and the four
    warps' partial sums where they split the contraction."""
    tw = ctw * 32 * vec
    red = 4 * 32 * rg * vec if ctw < 4 else 0
    return 4 * (BAR_INTS + C * rg + stages * cc * tw + red)


def plan(B: int, R: int, C: int, W: int, per_batch: bool, aligned: bool,
         sms: int) -> Plan:
    """K1's launch for words [B, C, W] and R output rows on a card of
    ``sms`` SMs; ``aligned``: both the words and the out pointer sit on
    16 bytes.  One block a work item (b, tile, row group)."""
    vec = 4 if W % 4 == 0 and aligned else 1
    ctw = 1
    while ctw < 4 and ctw * 32 * vec < W:
        ctw *= 2
    tw = ctw * 32 * vec
    tiles = -(-W // tw)
    rg = row_group(R)
    if rg > 8 and B * tiles * -(-R // rg) < sms // 2:
        rg = 8          # a small batch: more, smaller items
    groups = -(-R // rg)
    items = B * tiles * groups
    if 4 * max(C, 1) * tw <= NARROW_STAGE:
        cc, stages = max(C, 1), 1       # the whole slab in one stage
    else:
        # a ring of two stages of WIDE_STAGE; half that per stripe, or past
        # one wave where the larger ring keeps an SM from its `cap` blocks
        cap = 3 if rg * vec >= 96 else 4        # csrc min_blocks
        stage, stages = WIDE_STAGE, RING
        if per_batch or items > sms and SM_SMEM // (smem_needed(
                R, C, vec, rg, ctw, stage // (4 * tw), stages) + 1024) < cap:
            stage //= 2
        cc = max(1, min(C, stage // (4 * tw)))
    smem = smem_needed(R, C, vec, rg, ctw, cc, stages)
    return Plan(vec, rg, ctw, cc, stages, items, tiles, groups, smem)


# ------------------------------------------------------------------ kernel --

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from . import _build
    lib = _build.load("xor_matmul")
    plan_args = [ctypes.c_int] * 5
    lib.ceph_xor_matmul_w32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, *plan_args, ctypes.c_void_p]
    lib.ceph_xor_matmul_w32.restype = ctypes.c_int
    lib.ceph_xor_matmul_floor.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, *plan_args, ctypes.c_void_p]
    lib.ceph_xor_matmul_floor.restype = ctypes.c_int
    lib.ceph_xor_matmul_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.ceph_xor_matmul_smem_bytes.restype = ctypes.c_int
    lib.ceph_xor_matmul_smem_limit.argtypes = []
    lib.ceph_xor_matmul_smem_limit.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def _card(index: int):
    """(SM count, shared-memory limit a block) of one card, asked once."""
    with torch.cuda.device(index):
        return (torch.cuda.get_device_properties(index).multi_processor_count,
                _lib().ceph_xor_matmul_smem_limit())


@functools.lru_cache(maxsize=4096)
def _card_plan(B: int, R: int, C: int, W: int, per_batch: bool,
               aligned: bool, index: int) -> Plan:
    sms, limit = _card(index)
    p = plan(B, R, C, W, per_batch, aligned, sms)
    if p.smem > limit:
        raise ValueError(
            f"K1 needs {p.smem} B of shared memory a block for [{R}, {C}] "
            f"masks over {W} words; a block takes at most {limit} B")
    return p


def launch_plan(m3: torch.Tensor, w3: torch.Tensor,
                per_batch: bool) -> Plan:
    """The plan K1 launches with for these CUDA operands (cached per
    shape, alignment and card; raises when it needs more shared memory
    than a block may take)."""
    B, C, W = w3.shape
    # out is a fresh allocation, aligned as every block of the allocator
    return _card_plan(B, m3.shape[1], C, W, bool(per_batch),
                      w3.data_ptr() % 16 == 0, w3.device.index)


def smem_bytes(p: Plan, R: int, C: int):
    """(bytes, limit): the shared memory the kernel lays out for plan
    ``p`` (asked of the built library), and the most a block takes."""
    lib = _lib()
    return (lib.ceph_xor_matmul_smem_bytes(R, C, *p.args()),
            lib.ceph_xor_matmul_smem_limit())


def _on_card(fn, dev: torch.device, *args) -> int:
    """fn(*args, stream) with ``dev`` current, entering it only when it
    is not current already."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


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
    p = _card_plan(B, R, C, W, bool(per_batch),
                   (w3.data_ptr() | out.data_ptr()) % 16 == 0,
                   w3.device.index)
    rc = _on_card(_lib().ceph_xor_matmul_w32, w3.device, m3.data_ptr(),
                  w3.data_ptr(), out.data_ptr(), B, int(per_batch), R, C, W,
                  *p.args())
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


def _operands(masks, words):
    """(m3 [Bm, R, C], w3 [B, C, W], per_batch, leading axes) of the
    public entries' arguments, checked."""
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
    return (masks.reshape(B if per_batch else 1, R, C),
            words.reshape(B, C, W), per_batch, lead)


def xor_matmul_w32(masks, words) -> torch.Tensor:
    """int32-domain entry: masks [R, C] or [..., R, C], words [..., C, W]
    int32 -> [..., R, W] int32 on the words' device.

    A leading batch axis on ``masks`` must match ``words``'s leading
    axes elementwise (per-stripe decode signatures).  NumPy words go to
    the package default device; NumPy masks go to the words' device.
    """
    m3, w3, per_batch, lead = _operands(masks, words)
    if w3.device.type == "cuda":
        out = _launch(m3, w3, per_batch)
    elif w3.device.type == "cpu":
        global plain_runs
        plain_runs += 1
        out = _combine_torch(m3, w3)
    else:
        raise ValueError(f"K1 has no kernel for device {w3.device}")
    return out.reshape(lead + (m3.shape[1], w3.shape[2]))


def matmul_floor(masks, words) -> None:
    """The launch floor of K1 for these CUDA operands: an empty kernel
    launched at the grid, block and shared memory K1 takes for them.
    Not K1: it computes nothing and counts no launch."""
    m3, w3, per_batch, _ = _operands(masks, words)
    if w3.device.type != "cuda":
        raise ValueError(f"K1's floor runs on the card, not {w3.device}")
    B, C, W = w3.shape
    R = m3.shape[1]
    if B * R * W == 0:
        return
    p = launch_plan(m3, w3, per_batch)
    rc = _on_card(_lib().ceph_xor_matmul_floor, w3.device, B,
                  int(per_batch), R, C, W, *p.args())
    if rc != 0:
        raise RuntimeError(f"K1 floor launch failed: cudaError {rc} "
                           f"(masks {tuple(m3.shape)}, words "
                           f"{tuple(w3.shape)})")


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


# mask operands already uploaded, keyed like the lru above (same
# capacity and per-access recency, so eviction tracks it); locked, as
# OSD dispatcher threads upload concurrently (ops/gf_jax.py's pattern)
_seen_masks: collections.OrderedDict = collections.OrderedDict()
_seen_lock = threading.Lock()


def masks_to_device(bitmat: np.ndarray, device=None) -> torch.Tensor:
    """Host GF(2) bit-matrix [R, C] 0/1 -> cached device mask operand
    [R, C] int32 (0 / -1), keyed by content and device (the ISA-L
    table-cache role, src/erasure-code/isa/ErasureCodeIsaTableCache.h:35).

    The first upload of an operand is the port's counterpart of the
    reference's first compile of the masked-XOR executable for a new
    shape: a ``jit.compile`` child span of the op that caused it, with
    the reference's component ``ec.xor_kernel``.  It is a span only: the
    ``jit`` perf group keeps the reference's XLA compiles, which the
    port has none of."""
    bm = np.ascontiguousarray(bitmat, dtype=np.uint8)
    key = (bm.tobytes(), bm.shape, str(resolve_device(device)))
    with _seen_lock:
        first = key not in _seen_masks
        _seen_masks[key] = True
        _seen_masks.move_to_end(key)
        while len(_seen_masks) > _masks_device.cache_info().maxsize:
            _seen_masks.popitem(last=False)
    if not first:
        return _masks_device(key[0], *bm.shape, key[2])
    from ..common.tracer import child_span
    with child_span("jit.compile", component="ec.xor_kernel",
                    signature=f"{bm.shape[0]}x{bm.shape[1]}"):
        return _masks_device(key[0], *bm.shape, key[2])
