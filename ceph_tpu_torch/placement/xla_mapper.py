"""Batched CRUSH mapping on the card — north-star loop #1.

Port of ``ceph_tpu/placement/xla_mapper.py`` (the module keeps the
reference's name so the layout mirrors it).  It replaces the reference's
per-x interpreter stack (crush_do_rule, src/crush/mapper.c:900-1105;
CrushTester's triple loop, src/crush/CrushTester.cc:612-623; the
ParallelPGMapper thread-pool batcher, src/osd/OSDMapMapping.h:18) with
batched torch programs that map millions of PG ids at once:

  * The CrushMap compiles to dense padded arrays (``compile_map``, host
    code; ``CompiledMap`` stays NumPy).
  * ``DeviceTables`` holds them on the mapper's device with row gathers
    (the reference's 'gather' strategy; its 'onehot' strategy exists only
    to keep gathers off the TPU's matrix unit and is not ported).  The
    exact straw2 draw numerator is an index into the 65,536-entry table.
  * ``XlaMapper.map_batch`` dispatches to the level-synchronous
    FastMapper (fast_mapper.py), as the reference does; lanes it flags
    incomplete are recomputed exactly on the host by the native C++
    mapper, or else the scalar mapper — the reference's own design,
    counted in ``perf("crush.mapper")`` ``fallback_lanes``.

Bit-exactness contract: for supported maps (straw2 buckets, modern
tunables) the batch output equals scalar_mapper.do_rule element for
element.  The reference's general per-lane trace (``_trace_rule`` with
``_choose_firstn``/``_choose_indep`` and the legacy bucket algorithms) is
not in this slice: a rule or map outside the fast subset raises
UnsupportedMapError naming the later slice; it is never mapped quietly
on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..common.op_tracker import mark_active as _mark_active
from ..common.perf_counters import perf as _perf
from . import lntable
from .crush_map import (
    BUCKET_LIST, BUCKET_STRAW, BUCKET_STRAW2, BUCKET_TREE, BUCKET_UNIFORM,
    ITEM_NONE, CrushMap,
)

S64_MIN = lntable.S64_MIN


class UnsupportedMapError(Exception):
    """Map/rule uses features outside the vectorized subset."""


# what a rule outside the fast subset needs: the general per-lane mapper
_GENERAL_MAPPER = (
    "the general per-lane mapper (xla_mapper._trace_rule with the legacy "
    "bucket algorithms), which a later slice of the port carries "
    "(ROADMAP queue A)")


# ---------------------------------------------------------------- compile --

@dataclass(frozen=True)
class CompiledMap:
    """Dense, device-ready view of a CrushMap (all 5 bucket algs)."""
    items: np.ndarray        # i32 [B, S] child ids (pad 0)
    hash_ids: np.ndarray     # i32 [B, S] ids hashed by straw2 (choose_args)
    weight_sets: np.ndarray  # i32 [B, P, S] per-position weights
    sizes: np.ndarray        # i32 [B]
    types: np.ndarray        # i32 [B]
    algs: np.ndarray         # i32 [B] bucket algorithm
    bucket_ids: np.ndarray   # i32 [B] original (negative) bucket ids
    sum_weights: np.ndarray  # i64 [B, S]  LIST prefix sums (u32 values)
    straws: np.ndarray       # i64 [B, S]  STRAW v1 scalers (u32 values)
    node_weights: np.ndarray  # i64 [B, 2S] TREE interior-node weights
    num_nodes: np.ndarray    # i32 [B]
    n_buckets: int
    max_size: int
    n_positions: int
    max_devices: int
    max_depth: int
    all_straw2: bool

    def tables(self, device) -> "DeviceTables":
        return DeviceTables(self, device)


def compile_map(cmap: CrushMap, choose_args_key: object = None,
                n_positions: int = 1) -> CompiledMap:
    """Flatten the bucket hierarchy to padded arrays.

    Raises UnsupportedMapError for non-straw2 buckets or legacy local-retry
    tunables (the scalar mapper covers those).
    """
    t = cmap.tunables
    if t.choose_local_tries or t.choose_local_fallback_tries:
        raise UnsupportedMapError(
            "legacy local-retry tunables not vectorized (argonaut profile)")
    B = cmap.max_buckets
    if B == 0:
        raise UnsupportedMapError("map has no buckets")
    S = 1
    all_straw2 = True
    for b in cmap.buckets:
        if b is None:
            continue
        if b.alg not in (BUCKET_UNIFORM, BUCKET_LIST, BUCKET_TREE,
                         BUCKET_STRAW, BUCKET_STRAW2):
            raise UnsupportedMapError(
                f"bucket {b.id}: unknown algorithm {b.alg}")
        if b.alg != BUCKET_STRAW2:
            all_straw2 = False
        S = max(S, b.size)
        if b.alg == BUCKET_TREE and b.num_nodes:
            S = max(S, (b.num_nodes + 1) // 2)
    choose_args = cmap.choose_args.get(choose_args_key) \
        if choose_args_key is not None else None
    P = 1
    if choose_args is not None:
        for a in choose_args:
            if a is not None and a.weight_set is not None:
                P = max(P, len(a.weight_set))
    P = max(P, n_positions if choose_args is not None else 1)

    items = np.zeros((B, S), dtype=np.int32)
    hash_ids = np.zeros((B, S), dtype=np.int32)
    ws = np.zeros((B, P, S), dtype=np.int32)
    sizes = np.zeros(B, dtype=np.int32)
    types = np.zeros(B, dtype=np.int32)
    algs = np.full(B, BUCKET_STRAW2, dtype=np.int32)
    bucket_ids = np.zeros(B, dtype=np.int32)
    # u32 in the reference (crush_bucket_list::sum_weights,
    # crush_bucket_straw::straws); kept as int64 holding the mod-2^32
    # value so prefix sums >= 2^31 neither overflow the table dtype nor
    # lose the reference's u32 wrap semantics
    sum_weights = np.zeros((B, S), dtype=np.int64)
    straws = np.zeros((B, S), dtype=np.int64)
    node_weights = np.zeros((B, 2 * S), dtype=np.int64)
    num_nodes = np.zeros(B, dtype=np.int32)
    for idx, b in enumerate(cmap.buckets):
        if b is None:
            continue
        n = b.size
        sizes[idx] = n
        types[idx] = b.type
        algs[idx] = b.alg
        bucket_ids[idx] = b.id
        items[idx, :n] = b.items
        hash_ids[idx, :n] = b.items
        w_row = ([b.weights[0]] * n if b.alg == BUCKET_UNIFORM and
                 len(b.weights) == 1 and n > 1 else b.weights[:n])
        for p in range(P):
            ws[idx, p, :len(w_row)] = w_row
        if b.alg == BUCKET_LIST and b.sum_weights:
            sum_weights[idx, :n] = [w & 0xFFFFFFFF for w in b.sum_weights]
        if b.alg == BUCKET_STRAW and b.straws:
            straws[idx, :n] = [w & 0xFFFFFFFF for w in b.straws]
        if b.alg == BUCKET_TREE and b.node_weights:
            node_weights[idx, :len(b.node_weights)] = b.node_weights
            num_nodes[idx] = b.num_nodes
        if choose_args is not None and b.alg == BUCKET_STRAW2:
            # choose_args are consumed ONLY by straw2 selection
            # (mapper.c:309-326 via bucket_straw2_choose); legacy algs
            # keep their native weights, matching the scalar oracle
            arg = choose_args[idx] if idx < len(choose_args) else None
            if arg is not None:
                if arg.ids is not None:
                    hash_ids[idx, :n] = arg.ids
                if arg.weight_set is not None:
                    for p in range(P):
                        src = arg.weight_set[min(p, len(arg.weight_set) - 1)]
                        ws[idx, p, :n] = src

    # max descent depth: longest bucket→bucket chain + 1
    depth = np.ones(B, dtype=np.int64)
    # iterate to fixed point (hierarchies are DAG-ish and shallow)
    for _ in range(B):
        changed = False
        for idx, b in enumerate(cmap.buckets):
            if b is None:
                continue
            for it in b.items:
                if it < 0:
                    child = -1 - it
                    if child < B and depth[child] + 1 > depth[idx]:
                        depth[idx] = depth[child] + 1
                        changed = True
        if not changed:
            break
    return CompiledMap(
        items=items, hash_ids=hash_ids, weight_sets=ws, sizes=sizes,
        types=types, algs=algs, bucket_ids=bucket_ids,
        sum_weights=sum_weights, straws=straws,
        node_weights=node_weights, num_nodes=num_nodes,
        n_buckets=B, max_size=S, n_positions=P,
        max_devices=max(cmap.max_devices, 1), max_depth=int(depth.max()),
        all_straw2=all_straw2)


# ------------------------------------------------------------- primitives --

LN_SHIFT_F = float(lntable.LN_SHIFT)            # 2^48


class DeviceTables:
    """The straw2 numerator table on the mapper's device."""

    def __init__(self, cm: CompiledMap, device):
        self.cm = cm
        self.device = resolve_device(device)
        # 2^48 - crush_ln(u): the positive straw2 draw numerator, exact in
        # float64 (below 2^49); the level tables live in fast_mapper
        self.numer_lut = torch.as_tensor(
            (-lntable.straw2_ln_lut()).astype(np.float64),
            device=self.device)

    def ln_numer(self, u: torch.Tensor) -> torch.Tensor:
        """u [...] in [0, 0xFFFF] -> positive float64 numerator,
        bit-exact vs the LUT."""
        return self.numer_lut[u]


# ------------------------------------------------------- rule interpreter --

class XlaMapper:
    """Batched do_rule for one CrushMap on one device.

    Usage::

        mapper = XlaMapper(cmap)
        osds = mapper.map_batch(ruleno, xs, result_max, weights)  # [N, R]

    ``weights`` is the device in/out vector ([max_devices] 16.16 fixed,
    like the reference's __u32 *weight argument); results are padded with
    ITEM_NONE.  ``device`` is where the batched mapper runs (the package
    default, the card, when None).
    """

    def __init__(self, cmap: CrushMap, choose_args_key: object = None,
                 n_positions: int = 8, device=None):
        self.cmap = cmap
        self.choose_args_key = choose_args_key
        self.device = resolve_device(device)
        self.compiled = compile_map(cmap, choose_args_key, n_positions)
        self._fast = None                 # lazy FastMapper
        self._exact_fallback = None       # lazy NativeMapper/scalar fn

    def _exact_rows(self, ruleno: int, xs_rows, result_max: int, weights):
        """Bit-exact recompute for incomplete lanes: the native C++
        interpreter when buildable, else the scalar mapper."""
        if self._exact_fallback is None:
            try:
                from ..native_bridge import NativeMapper
                nm = NativeMapper(self.cmap,
                                  choose_args_key=self.choose_args_key)
                self._exact_fallback = (
                    lambda rn, xr, rm, w: nm.map_batch(rn, xr, rm, w))
            except Exception:
                args = self.cmap.choose_args.get(self.choose_args_key) \
                    if self.choose_args_key is not None else None

                def scalar_rows(rn, xr, rm, w):
                    res = np.full((len(xr), rm), ITEM_NONE, dtype=np.int32)
                    for i, xv in enumerate(xr):
                        got = scalar_do_rule(self.cmap, rn, int(xv), rm,
                                             list(w), choose_args=args)
                        res[i, :len(got)] = got
                    return res

                from .scalar_mapper import do_rule as scalar_do_rule
                self._exact_fallback = scalar_rows
        return self._exact_fallback(ruleno, xs_rows, result_max, weights)

    def map_batch_delta(self, ruleno: int, xs, result_max: int,
                        old_weights, new_weights,
                        before: np.ndarray) -> np.ndarray:
        """Epoch-delta remap: O(changed) instead of O(all PGs) for
        MONOTONIC device-weight decreases — the mark-out/failure case
        that drives recovery (the reference pays the full
        OSDMapMapping sweep here, src/osd/OSDMapMapping.h:18;
        CrushTester.cc:612 loops every x).

        ``before`` is the cached full mapping under ``old_weights``
        (a live mon/mgr always holds the current epoch's mapping).
        Only rows whose mapping CONTAINS a changed device recompute;
        every other row provably keeps its result:

          * the crush map (bucket weights, items, choose_args) is
            unchanged, so every straw2 draw sequence is unchanged —
            each lane SELECTS the same item sequence at every bucket
            and retry step;
          * a lane that never ACCEPTED a changed device either never
            selected it (identical draws), or selected-and-REJECTED
            it: collision rejection is weight-independent, and the
            probabilistic is_out rejection (mapper.c:424-438,
            hash(x,d) & 0xffff >= w) is monotone — a weight that only
            DECREASES keeps every past rejection a rejection.  By
            induction the whole retry path, including exhausted
            (ITEM_NONE) slots, is bit-identical;
          * a lane that accepted a changed device is exactly a lane
            whose ``before`` row contains it.

        Weight INCREASES (revive/mark-in) can attract lanes that
        never probed the device, so there is no sound affected-set
        short of a sweep — those fall back to the full map_batch."""
        old = np.asarray(old_weights, dtype=np.int64)
        new = np.asarray(new_weights, dtype=np.int64)
        pc = _perf("crush.mapper")
        if (new > old).any():
            pc.inc("delta_full_fallbacks")
            return self.map_batch(ruleno, xs, result_max, new_weights)
        changed = np.flatnonzero(new != old)
        if not len(changed):
            return before.copy()
        affected = np.isin(before, changed).any(axis=1)
        rows = np.flatnonzero(affected)
        pc.inc("delta_calls")
        pc.inc("delta_affected_lanes", len(rows))
        out = before.copy()
        if len(rows):
            out[rows] = self.map_batch(
                ruleno, np.asarray(xs)[rows], result_max, new_weights)
        return out

    def map_batch(self, ruleno: int, xs, result_max: int,
                  weights: Sequence[int]) -> np.ndarray:
        """[N] x values -> [N, result_max] i32 osd ids (ITEM_NONE padded).

        The level-synchronous FastMapper maps every lane on the device;
        lanes it flags incomplete are recomputed bit-exactly on the host.
        A rule or map outside its subset raises UnsupportedMapError."""
        if ruleno < 0 or ruleno >= self.cmap.max_rules or \
                self.cmap.rules[ruleno] is None:
            raise ValueError(f"no rule {ruleno}")
        pc = _perf("crush.mapper")
        pc.inc("map_batch_calls")
        pc.inc("lanes", len(xs))
        try:
            if self._fast is None:
                from .fast_mapper import FastMapper
                self._fast = FastMapper(
                    self.cmap, choose_args_key=self.choose_args_key,
                    device=self.device)
            _mark_active("dispatched_device", component="crush.fastmap",
                         lanes=len(xs))
            with pc.time("fast_map_s"):
                out, inc = self._fast.map_batch(
                    ruleno, xs, result_max, weights)
        except UnsupportedMapError as e:
            pc.inc("fast_unsupported_rules")
            raise UnsupportedMapError(
                f"{e}; rule {ruleno} needs {_GENERAL_MAPPER}") from e
        if inc.any():
            rows = np.flatnonzero(inc)
            pc.inc("fallback_lanes", len(rows))
            xs_np = np.asarray(xs, dtype=np.int64)[rows]
            out[rows] = self._exact_rows(ruleno, xs_np, result_max, weights)
        return out
