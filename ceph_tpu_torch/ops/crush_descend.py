"""The fast mapper's straw2 descent on the card: ``csrc/crush_descend.cu``.

One launch walks every level of one candidate grid's descents, for each
row the rjenkins hash3, the ``crush_ln`` numerator, the exact integer
quotient, the first-index argmin and the level's bookkeeping, and writes
each row's (item, status, leafrow) once.  Its plain version is
``placement/fast_mapper._descend_batch``, which the fast mapper runs on a
CPU tensor; a CUDA tensor launches the kernel or raises.

The level tables are packed once for the kernel (:func:`pack`): for each
item a 16-byte hot record (hash id, weight, the weight's correctly rounded
reciprocal) read at every draw, and a 16-byte child record (id, type with
the escape flag, next-level row, leaf-class row) read once a level.

``launches`` counts the kernel's launches (incremented where it is
launched, nowhere else), ``descend_kernel_rows`` the grid rows they
served and ``descend_torch_rows`` those the plain version served.  Like
K1-K3's launch counts they are module counts, outside the perf registry,
whose groups carry the reference's keys (the dashboard and the
Prometheus module serve them).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as np
import torch

ESCAPE = 1 << 30          # the child record's escape flag (kEscape)
MAX_LEVELS = 16           # kMaxLevels
GROUPS = (1, 4, 32)       # lanes a row the kernel is built for

launches = 0
descend_kernel_rows = 0
descend_torch_rows = 0
_count_lock = threading.Lock()


def count_torch_rows(rows: int) -> None:
    """The plain version served ``rows`` grid rows."""
    global descend_torch_rows
    with _count_lock:
        descend_torch_rows += rows


class DescentTables:
    """One descent's levels packed for the kernel on one device.

    ``items`` [T, 2] int64 (hash id and weight in the first word, the
    reciprocal's float64 bits in the second), ``children`` [T, 4] int32,
    ``sizes`` [Tb] int32, and ``desc`` [levels, 4] int64 on the host: each
    level's first record, first size, rows and width."""

    def __init__(self, items, children, sizes, desc: np.ndarray):
        self.items = items
        self.children = children
        self.sizes = sizes
        self.desc = np.ascontiguousarray(desc, dtype=np.int64)
        self.device = items.device

    @property
    def n_levels(self) -> int:
        return int(self.desc.shape[0])

    @property
    def max_width(self) -> int:
        return int(self.desc[:, 3].max())


def reciprocals(w: np.ndarray) -> np.ndarray:
    """float64 1/w, correctly rounded, for each weight w > 0 (0 else)."""
    w = np.asarray(w, dtype=np.int64)
    rcp = np.zeros(w.shape, dtype=np.float64)
    np.divide(1.0, w, out=rcp, where=w > 0)
    return rcp


def pack(levels: Sequence[tuple], device) -> DescentTables:
    """Pack a descent's levels: each a tuple of host arrays (items,
    hash_ids, weights, sizes, child_row, child_type, child_escape,
    child_leafrow), every one [rows, width] but sizes [rows] and weights
    the choose_args position's [rows, width]."""
    if not 0 < len(levels) <= MAX_LEVELS:
        raise ValueError(f"{len(levels)} levels: the kernel walks 1 to "
                         f"{MAX_LEVELS}")
    hot, cold, sizes, desc = [], [], [], []
    n_items = n_sizes = 0
    for (items, hash_ids, weights, lsizes, child_row, child_type,
         child_escape, child_leafrow) in levels:
        rows, width = items.shape
        w = np.asarray(weights, dtype=np.int64).reshape(-1)
        rcp = reciprocals(w)
        word = (np.asarray(hash_ids, np.int64).reshape(-1) & 0xFFFFFFFF) | \
            ((w & 0xFFFFFFFF) << 32)
        hot.append(np.stack([word, rcp.view(np.int64)], axis=1))
        ctype = np.asarray(child_type, np.int64)
        if ctype.size and (ctype.min() < 0 or ctype.max() >= ESCAPE):
            raise ValueError("a bucket type outside [0, 2^30)")
        cold.append(np.stack([
            np.asarray(items, np.int32).reshape(-1),
            (ctype | np.where(child_escape, ESCAPE, 0)).astype(
                np.int32).reshape(-1),
            np.asarray(child_row, np.int32).reshape(-1),
            np.asarray(child_leafrow, np.int32).reshape(-1)], axis=1))
        sizes.append(np.asarray(lsizes, np.int32).reshape(-1))
        desc.append((n_items, n_sizes, rows, width))
        n_items += rows * width
        n_sizes += rows

    def up(parts, dtype):
        a = np.ascontiguousarray(np.concatenate(parts), dtype=dtype)
        return torch.as_tensor(a, device=device)

    return DescentTables(up(hot, np.int64), up(cold, np.int32),
                         up(sizes, np.int32), np.asarray(desc, np.int64))


def _lib() -> ctypes.CDLL:
    from . import _build
    lib = _build.load("crush_descend")
    p = ctypes.c_void_p
    lib.ceph_crush_descend.argtypes = [
        p, p, p, p, p, ctypes.c_int, p, p, p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p, p]
    lib.ceph_crush_descend.restype = ctypes.c_int
    lib.ceph_crush_descend_floor.argtypes = [
        p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p]
    lib.ceph_crush_descend_floor.restype = ctypes.c_int
    lib.ceph_crush_descend_group.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.ceph_crush_descend_group.restype = ctypes.c_int
    lib.ceph_crush_descend_quotients.argtypes = [p, p, p, p, p,
                                                 ctypes.c_longlong, p]
    lib.ceph_crush_descend_quotients.restype = ctypes.c_int
    return lib


def _check(tabs: DescentTables, numer, x, row0, r, group) -> None:
    """Refuse what the kernel cannot take, before any launch."""
    named = (("x", x), ("row0", row0), ("r", r))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
    if not isinstance(numer, torch.Tensor) or \
            numer.dtype != torch.float64 or tuple(numer.shape) != (65536,):
        raise TypeError("numer must be the [65536] float64 numerator table")
    if x.dim() != 1 or row0.dim() != 2 or row0.shape != r.shape or \
            row0.shape[0] != x.shape[0]:
        raise ValueError(f"want x [N] and row0, r [N, K]; got "
                         f"{tuple(x.shape)}, {tuple(row0.shape)}, "
                         f"{tuple(r.shape)}")
    for name, t in named + (("numer", numer),):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if group is not None and group not in GROUPS:
        raise ValueError(f"group {group}: one of {GROUPS}")
    for name, t in named + (("numer", numer),):
        if t.device.type != "cuda" or t.device != tabs.device:
            raise ValueError(
                f"{name} is on {t.device}: the descent kernel runs on the "
                f"tables' CUDA device ({tabs.device}); the plain version "
                f"runs on the CPU")


def descend(tabs: DescentTables, numer, x, row0, r, target_type: int,
            want_leafrow: bool, group=None):
    """x [N]; row0, r [N, K]; all int64 and contiguous on the tables' CUDA
    device, numer the mapper's ``DeviceTables.numer_lut`` -> (item,
    status, leafrow), each [N, K] int64, as the plain version gives.
    ``group`` forces the lanes a row (1, 4 or 32); None lets the launch
    choose."""
    global launches, descend_kernel_rows
    _check(tabs, numer, x, row0, r, group)
    N, K = row0.shape
    outs = tuple(torch.empty((N, K), dtype=torch.int64, device=x.device)
                 for _ in range(3))
    if N * K == 0:
        return outs
    dev = x.device
    with torch.cuda.device(dev):
        rc = _lib().ceph_crush_descend(
            tabs.items.data_ptr(), tabs.children.data_ptr(),
            tabs.sizes.data_ptr(), numer.data_ptr(), tabs.desc.ctypes.data,
            tabs.n_levels, x.data_ptr(), row0.data_ptr(), r.data_ptr(), N, K,
            int(target_type), int(bool(want_leafrow)), group or 0,
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"descent kernel launch failed: cudaError {rc} "
                           f"(grid [{N}, {K}], {tabs.n_levels} levels)")
    with _count_lock:
        launches += 1
        descend_kernel_rows += N * K
    return outs


def descend_floor(tabs: DescentTables, N: int, K: int, group=None) -> None:
    """The launch floor for an [N, K] grid over these levels: an empty
    kernel launched with the descent's grid, block and shared memory.
    Computes nothing and counts no launch."""
    dev = tabs.device
    with torch.cuda.device(dev):
        rc = _lib().ceph_crush_descend_floor(
            tabs.desc.ctypes.data, tabs.n_levels, N, K, group or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"descent floor launch failed: cudaError {rc}")


def group_for(tabs: DescentTables, rows: int) -> int:
    """The lanes a row a launch over ``rows`` rows of these levels takes."""
    with torch.cuda.device(tabs.device):
        return int(_lib().ceph_crush_descend_group(rows, tabs.max_width))


def quotients(numer, u: np.ndarray, w: np.ndarray):
    """The kernel's quotient alone: host arrays u, w [n] -> floor(numer[u]
    / w) [n] int64 on numer's CUDA device (-1 where w <= 0), through the
    same device function and reciprocals as the descent.  For the
    tests."""
    dev = numer.device
    u_d = torch.as_tensor(np.ascontiguousarray(u, np.int64), device=dev)
    w_d = torch.as_tensor(np.ascontiguousarray(w, np.int64), device=dev)
    rcp = torch.as_tensor(reciprocals(w), device=dev)
    out = torch.empty_like(u_d)
    with torch.cuda.device(dev):
        rc = _lib().ceph_crush_descend_quotients(
            numer.data_ptr(), u_d.data_ptr(), w_d.data_ptr(), rcp.data_ptr(),
            out.data_ptr(), u_d.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quotient launch failed: cudaError {rc}")
    return out
