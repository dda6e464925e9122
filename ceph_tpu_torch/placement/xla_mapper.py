"""Batched CRUSH mapping on the card — north-star loop #1.

Port of ``ceph_tpu/placement/xla_mapper.py`` (the module keeps the
reference's name so the layout mirrors it).  It replaces the reference's
per-x interpreter stack (crush_do_rule, src/crush/mapper.c:900-1105;
CrushTester's triple loop, src/crush/CrushTester.cc:612-623; the
ParallelPGMapper thread-pool batcher, src/osd/OSDMapMapping.h:18) with
batched torch programs that map millions of PG ids at once:

  * The CrushMap compiles to dense padded arrays (``compile_map``, host
    code; ``CompiledMap`` stays NumPy) for all five bucket algorithms.
  * ``DeviceTables`` holds them on the mapper's device with row gathers
    (the reference's 'gather' strategy; its 'onehot' strategy exists only
    to keep gathers off the TPU's matrix unit and is not ported).  The
    exact straw2 draw numerator is an index into the 65,536-entry table.
  * ``XlaMapper.map_batch`` dispatches to the level-synchronous
    FastMapper (fast_mapper.py) first, as the reference does (on the card
    its descents run in the hand-written kernel ops/crush_descend); lanes it
    flags incomplete are recomputed exactly on the host by the native C++
    mapper, or else the scalar mapper — the reference's own design,
    counted in ``perf("crush.mapper")`` ``fallback_lanes``.
  * A rule or map outside the fast subset (legacy uniform/list/tree/straw
    buckets, chained choose steps, ``fastmap_enabled=false``) runs the
    general per-lane interpreter below (``XlaMapper._trace_rule``): the
    rule steps are a Python loop, and each lane carries its own retry
    state.  The reference vmaps ``lax.while_loop``s over x; here every
    loop runs over the lanes still active, compacted by index as lanes
    finish, bounded by the reference's own limits (``tries``,
    ``recurse_tries``, ``max_depth``).  Every lane completes on the
    device: nothing of this path is handed to a host mapper.

Bit-exactness contract: the batch output equals scalar_mapper.do_rule
element for element for every map ``compile_map`` accepts; only the
argonaut profile's local-retry tunables raise UnsupportedMapError.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..common import tracer as _tracing
from ..common.op_tracker import mark_active as _mark_active
from ..common.options import config as _config
from ..common.perf_counters import perf as _perf
from ..ops import hashing
from . import lntable
from .crush_map import (
    BUCKET_LIST, BUCKET_STRAW, BUCKET_STRAW2, BUCKET_TREE, BUCKET_UNIFORM,
    ITEM_NONE, ITEM_UNDEF,
    RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP, RULE_CHOOSE_FIRSTN,
    RULE_CHOOSE_INDEP, RULE_EMIT, RULE_SET_CHOOSELEAF_STABLE,
    RULE_SET_CHOOSELEAF_TRIES, RULE_SET_CHOOSELEAF_VARY_R,
    RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES, RULE_SET_CHOOSE_LOCAL_TRIES,
    RULE_SET_CHOOSE_TRIES, RULE_TAKE, CrushMap,
)

S64_MIN = lntable.S64_MIN
_I64 = torch.int64


class UnsupportedMapError(Exception):
    """Map/rule uses features outside the vectorized subset."""


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

    Raises UnsupportedMapError for an unknown bucket algorithm or the
    legacy local-retry tunables (the scalar mapper covers those).
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
    """The compiled map's tables on the mapper's device, read by row
    gathers (int64 throughout; u32 table values stay below 2^32)."""

    def __init__(self, cm: CompiledMap, device):
        self.cm = cm
        self.device = resolve_device(device)
        self.B, self.S, self.P = cm.n_buckets, cm.max_size, cm.n_positions
        # 2^48 - crush_ln(u): the positive straw2 draw numerator, exact in
        # float64 (below 2^49)
        self.numer_lut = torch.as_tensor(
            (-lntable.straw2_ln_lut()).astype(np.float64),
            device=self.device)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   device=self.device).to(_I64)

        self.items = t(cm.items)                  # [B, S]
        self.hash_ids = t(cm.hash_ids)            # [B, S]
        self.weight_sets = t(cm.weight_sets)      # [B, P, S]
        self.sizes = t(cm.sizes)                  # [B]
        self.types = t(cm.types)                  # [B]
        # the algorithms a lane can meet: one sub-batch per algorithm
        self.alg_list = sorted({int(a) for a in cm.algs})
        if not cm.all_straw2:
            self.algs = t(cm.algs)
            self.bucket_ids = t(cm.bucket_ids)
            self.sum_weights = t(cm.sum_weights)  # [B, S]
            self.straws = t(cm.straws)            # [B, S]
            self.node_weights = t(cm.node_weights)  # [B, 2S]
            self.num_nodes = t(cm.num_nodes)      # [B]

    def ln_numer(self, u: torch.Tensor) -> torch.Tensor:
        """u [...] in [0, 0xFFFF] -> positive float64 numerator,
        bit-exact vs the LUT."""
        return self.numer_lut[u]


def _straw2_select(dt: DeviceTables, u, w, sizes) -> torch.Tensor:
    """Exact argmin of the straw2 draws over the item axis -> j [L].

    The reference draw is trunc_div(crush_ln(u) - 2^48, weight) maximized
    with first-index tie-break; negated, q = numer // w minimized.  q is
    the float64 quotient corrected one step each way: the dividend is
    below 2^48 and every product below 2^53, so q is the exact integer
    quotient.  torch.argmin returns the first minimum, the scalar scan's
    tie-break."""
    Sl = u.shape[1]
    valid = (w > 0) & \
        (torch.arange(Sl, dtype=_I64, device=u.device) < sizes[:, None])
    a = dt.ln_numer(u)
    wf = w.to(torch.float64)
    q = torch.floor(a / wf.clamp(min=1.0))
    q = q - (q * wf > a).to(q.dtype)
    q = q + ((q + 1.0) * wf <= a).to(q.dtype)
    q = torch.where(valid, q, torch.full_like(q, float("inf")))
    return torch.argmin(q, dim=1)


def _is_out(weights: torch.Tensor, item: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """Device overload rejection (mapper.c:424-438), batched over [L]."""
    n = weights.shape[0]
    w = weights[item.clamp(0, n - 1)]
    oob = item >= n
    hashed = (hashing.jx_hash2(x, item) & 0xFFFF) >= w
    return oob | ((w < 0x10000) & ((w == 0) | hashed))


def _pick(rows: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """rows[l, j[l]] for [L, S] rows."""
    return torch.take_along_dim(rows, j[:, None], dim=1)[:, 0]


def _nz(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the set lanes of a [L] mask."""
    return torch.nonzero(mask).reshape(-1)


# Each bucket choice below maps lanes [L] (bucket index c, x, r, weight-set
# position pos) to the chosen child id [L], gathering its bucket's row as
# [L, S].

def _straw2_choose(dt: DeviceTables, c, x, r, pos):
    """straw2 (mapper.c:361-384), the same exact draw as the fast mapper."""
    items = dt.items[c]
    w = dt.weight_sets[c, pos.clamp(max=dt.P - 1)]
    u = hashing.jx_hash3(x[:, None], dt.hash_ids[c], r[:, None]) & 0xFFFF
    return _pick(items, _straw2_select(dt, u, w, dt.sizes[c]))


def _uniform_choose(dt: DeviceTables, c, x, r, pos):
    """bucket_perm_choose (mapper.c:74-133): the r-th element of an
    incrementally built pseudo-random permutation, rebuilt from (x, r):
    starting from the identity, step p = 0..pr swaps perm[p] with
    perm[p + hash(x, id, p) % (n - p)].  The per-lane trip count pr + 1
    is batched as one [L, S] perm that the lanes with pr >= p update."""
    S = dt.S
    L = c.shape[0]
    n = dt.sizes[c]                     # never 0: _descend skips empties
    bid = dt.bucket_ids[c]
    pr = r % n
    perm = torch.arange(S, dtype=_I64, device=c.device).repeat(L, 1)
    act = torch.arange(L, dtype=_I64, device=c.device)
    p = 0
    while act.numel():
        na = n[act]
        i = hashing.jx_hash3(x[act], bid[act], torch.full_like(na, p)) \
            % (na - p)
        do = (p < na - 1) & (i != 0)
        b = p + i                       # below n: i < n - p
        pi = perm[act, p]
        pj = perm[act, b]
        perm[act, p] = torch.where(do, pj, pi)
        perm[act, b] = torch.where(do, pi, pj)
        p += 1
        act = act[pr[act] >= p]
    return _pick(dt.items[c], _pick(perm, pr))


def _list_choose(dt: DeviceTables, c, x, r, pos):
    """bucket_list_choose (mapper.c:139-160): scan from the list tail;
    take the highest index whose 16-bit draw scaled by the prefix sum
    undercuts the item weight, else items[0]."""
    S = dt.S
    items = dt.items[c]
    h = hashing.jx_hash4(x[:, None], items, r[:, None],
                         dt.bucket_ids[c][:, None]) & 0xFFFF
    draw = (h * dt.sum_weights[c]) >> 16
    ar = torch.arange(S, dtype=_I64, device=c.device)
    ok = (draw < dt.weight_sets[c, 0]) & (ar < dt.sizes[c][:, None])
    idx = torch.where(ok, ar, torch.full_like(ar, -1)).amax(dim=1)
    return _pick(items, idx.clamp(min=0))


def _tree_choose(dt: DeviceTables, c, x, r, pos):
    """bucket_tree_choose (mapper.c:180-219): descend the interior weight
    tree from the root node num_nodes/2; at node n the 32.32 draw
    t = (hash * weight(n)) >> 32 goes left when it undercuts the left
    child's weight.  The product is u64 in the reference (a node weight
    reaches 2^31 once a subtree holds about 32k OSD weights); with the
    weight split in 16-bit halves, t = (h*w_hi + ((h*w_lo) >> 16)) >> 16
    is exact in int64 for every u32 weight.  A node's step to its
    children is half its lowest set bit (the reference's trailing-zero
    height)."""
    nw = dt.node_weights[c]                     # [L, NW]
    NW = nw.shape[1]
    n = dt.num_nodes[c] >> 1
    bid = dt.bucket_ids[c]
    act = torch.arange(c.shape[0], dtype=_I64, device=c.device)
    for _ in range(NW.bit_length() + 1):
        act = act[(n[act] & 1) == 0]
        if not act.numel():
            break
        na = n[act]
        w = nw[act, na.clamp(0, NW - 1)]
        h = hashing.jx_hash4(x[act], na, r[act], bid[act])
        t = (h * (w >> 16) + ((h * (w & 0xFFFF)) >> 16)) >> 16
        step = ((na & -na) >> 1).clamp(min=1)
        left = na - step
        lw = nw[act, left.clamp(0, NW - 1)]
        n[act] = torch.where(t < lw, left, na + step)
    else:
        if ((n & 1) == 0).any():
            raise UnsupportedMapError("tree bucket deeper than its nodes")
    return _pick(dt.items[c], (n >> 1).clamp(0, dt.S - 1))


def _straw_choose(dt: DeviceTables, c, x, r, pos):
    """bucket_straw_choose (mapper.c:224-241): 16-bit draw times the
    precomputed straw scaler, argmax with first-index tie-break."""
    items = dt.items[c]
    h = hashing.jx_hash3(x[:, None], items, r[:, None]) & 0xFFFF
    draw = h * dt.straws[c]                       # below 2^48, exact
    ar = torch.arange(dt.S, dtype=_I64, device=c.device)
    draw = torch.where(ar < dt.sizes[c][:, None], draw,
                       torch.full_like(draw, -1))
    return _pick(items, torch.argmax(draw, dim=1))


_CHOOSE = {BUCKET_UNIFORM: _uniform_choose, BUCKET_LIST: _list_choose,
           BUCKET_TREE: _tree_choose, BUCKET_STRAW: _straw_choose,
           BUCKET_STRAW2: _straw2_choose}


def _bucket_choose(dt: DeviceTables, c, x, r, pos):
    """Per-algorithm dispatch (crush_bucket_choose, mapper.c:387-418): one
    masked sub-batch per algorithm the map holds; a map of one algorithm
    (every straw2 map) takes its choice directly."""
    if len(dt.alg_list) == 1:
        return _CHOOSE[dt.alg_list[0]](dt, c, x, r, pos)
    alg = dt.algs[c]
    item = torch.zeros_like(c)
    for a in dt.alg_list:
        sel = _nz(alg == a)
        if sel.numel():
            item[sel] = _CHOOSE[a](dt, c[sel], x[sel], r[sel], pos[sel])
    return item


# descend outcome codes
_OK, _REJECT, _SKIP = 0, 1, 2


def _descend(dt: DeviceTables, bidx, target_type: int, x, r, pos,
             bump: Optional[Tuple[int, int]] = None):
    """Walk from bucket index down to an item of target_type.

    Mirrors the inner retry_bucket walk of mapper.c:495-546: returns
    (item, status, r_at) per lane with status OK (item has target type),
    REJECT (empty bucket on the path: costs a retry) or SKIP (escaped
    the map: abandon this replica slot), and r_at the r of the level
    that ended the walk.  Each level chooses only for the lanes still
    walking.

    ``bump`` = (numrep, ftotal) is crush_choose_indep's r schedule
    (mapper.c:692-698): r is rep + parent_r + numrep * ftotal, and
    (numrep + 1) * ftotal in a uniform bucket whose size numrep divides,
    decided afresh at every level of the walk.  Here ``r`` carries the
    numrep * ftotal term and a lane in such a bucket adds ftotal."""
    cm = dt.cm
    L = bidx.shape[0]
    dev = bidx.device
    result = torch.full((L,), ITEM_NONE, dtype=_I64, device=dev)
    status = torch.full((L,), _REJECT, dtype=_I64, device=dev)
    # the reference's gathers clamp an index past the table
    cur = bidx.clamp(0, cm.n_buckets - 1)
    act = torch.arange(L, dtype=_I64, device=dev)
    bump_uniform = bump is not None and bump[1] > 0 and \
        BUCKET_UNIFORM in dt.alg_list
    r_at = r.clone() if bump_uniform else r
    for _ in range(cm.max_depth):
        if not act.numel():
            break
        c = cur[act]
        empty = dt.sizes[c] == 0
        # an empty bucket's choice is never read: choose for the rest
        item = torch.zeros_like(c)
        full = _nz(~empty)
        if full.numel():
            ai = act[full]
            cf = c[full]
            rl = r[ai]
            if bump_uniform:
                numrep, ftotal = bump
                rl = rl + ftotal * ((dt.algs[cf] == BUCKET_UNIFORM) &
                                    (dt.sizes[cf] % numrep == 0))
                r_at[ai] = rl
            item[full] = _bucket_choose(dt, cf, x[ai], rl, pos[ai])
        is_dev = item >= 0
        nb = torch.where(is_dev, torch.zeros_like(item), -1 - item)
        bad_dev = is_dev & (item >= cm.max_devices)
        bad_bucket = (~is_dev) & (nb >= cm.n_buckets)
        itype = torch.where(is_dev, torch.zeros_like(item),
                            dt.types[nb.clamp(0, cm.n_buckets - 1)])
        match = itype == target_type
        lvl_skip = (~empty) & (bad_dev | ((~match) & (is_dev | bad_bucket)))
        lvl_done = empty | lvl_skip | match
        status[act] = torch.where(
            empty, _REJECT, torch.where(lvl_skip, _SKIP, _OK))
        hit = match & (~empty)
        result[act[hit]] = item[hit]
        go = ~lvl_done
        cur[act[go]] = nb[go]
        act = act[go]
    # not terminating within max_depth == malformed map: SKIP
    status[act] = _SKIP
    return result, status, r_at


# --------------------------------------------------------------- firstn ----

def _leaf_firstn(dt, bidx, weights, x, sub_r, recurse_tries: int,
                 stable: bool, out2, outpos, pos):
    """The chooseleaf recursion (mapper.c:564-581 → recursive
    crush_choose_firstn with numrep=1): one device inside bucket ``bidx``'s
    subtree, with collision checks against out2[:outpos].
    Returns (device, ok) per lane."""
    L = bidx.shape[0]
    dev_ = bidx.device
    R = out2.shape[1]
    slots = torch.arange(R, dtype=_I64, device=dev_)
    rep_base = torch.zeros_like(outpos) if stable else outpos
    out_dev = torch.full((L,), ITEM_NONE, dtype=_I64, device=dev_)
    ok = torch.zeros((L,), dtype=torch.bool, device=dev_)
    act = torch.arange(L, dtype=_I64, device=dev_)
    for ftotal in range(recurse_tries):
        if not act.numel():
            break
        r = rep_base[act] + sub_r[act] + ftotal
        item, status, _ = _descend(dt, bidx[act], 0, x[act], r, pos[act])
        collide = ((slots < outpos[act, None]) &
                   (out2[act] == item[:, None])).any(dim=1)
        good = (status == _OK) & (~collide)
        success = good & (~_is_out(weights, item, x[act]))
        out_dev[act[success]] = item[success]
        ok[act[success]] = True
        act = act[(~success) & (status != _SKIP)]
    return out_dev, ok


def _choose_firstn(dt, bidx, target_type: int, numrep: int,
                   recurse_to_leaf: bool, tries: int, recurse_tries: int,
                   vary_r: int, stable: bool, weights, x, count_limit):
    """crush_choose_firstn (mapper.c:460-648) per lane, rule level
    (parent_r 0).  bidx [L] is the root bucket's index, count_limit [L]
    the room left in the result.  Returns (out, out2, outpos): out/out2
    [L, numrep] padded with ITEM_NONE."""
    L = bidx.shape[0]
    dev_ = bidx.device
    R = numrep
    slots = torch.arange(R, dtype=_I64, device=dev_)
    # one spare column takes the writes of lanes that place nothing
    out = torch.full((L, R + 1), ITEM_NONE, dtype=_I64, device=dev_)
    out2 = out.clone()
    outpos = torch.zeros((L,), dtype=_I64, device=dev_)
    for rep in range(numrep):           # mapper.c:478 rep loop
        ftotal = torch.zeros((L,), dtype=_I64, device=dev_)
        placed = torch.zeros((L,), dtype=torch.bool, device=dev_)
        item_sel = torch.full((L,), ITEM_NONE, dtype=_I64, device=dev_)
        leaf_sel = item_sel.clone()
        act = torch.arange(L, dtype=_I64, device=dev_)
        while act.numel():
            r = rep + ftotal[act]
            pos = outpos[act]
            xa = x[act]
            item, status, _ = _descend(dt, bidx[act], target_type, xa, r,
                                       pos)
            collide = ((slots < pos[:, None]) &
                       (out[act, :R] == item[:, None])).any(dim=1)
            good = (status == _OK) & (~collide)
            reject = status == _REJECT
            leaf = item
            if recurse_to_leaf:
                need = _nz(good & (item < 0))
                if need.numel():
                    sub_r = (r[need] >> (vary_r - 1)) if vary_r else \
                        torch.zeros_like(need)
                    ldev, lok = _leaf_firstn(
                        dt, -1 - item[need], weights, xa[need], sub_r,
                        recurse_tries, stable, out2[act[need], :R],
                        pos[need], pos[need])
                    leaf = item.clone()
                    leaf[need] = ldev
                    reject[need] |= ~lok
            if target_type == 0:
                reject = reject | (good & _is_out(weights, item, xa))
            ok = good & (~reject)
            skip = status == _SKIP
            fail = (~ok) & (~skip)
            ftotal[act] += fail.to(_I64)
            done = act[ok]
            placed[done] = True
            item_sel[done] = item[ok]
            leaf_sel[done] = leaf[ok]
            act = act[fail & (ftotal[act] < tries)]
        placed &= outpos < count_limit
        col = torch.where(placed, outpos, torch.full_like(outpos, R))[:, None]
        out.scatter_(1, col, item_sel[:, None])
        if recurse_to_leaf:
            out2.scatter_(1, col, leaf_sel[:, None])
        outpos += placed.to(_I64)
    return out[:, :R], out2[:, :R], outpos


# ---------------------------------------------------------------- indep ----

def _leaf_indep(dt, bidx, weights, x, parent_r, rep: int, numrep: int,
                recurse_tries: int, pos: int):
    """Leaf recursion of crush_choose_indep (mapper.c:777-792): one device
    in the subtree, positionally stable; no collision window (the
    recursion window is a single slot).  parent_r [L] is the r of the
    level that chose the parent.  Returns device or ITEM_NONE."""
    L = bidx.shape[0]
    dev_ = bidx.device
    out_dev = torch.full((L,), ITEM_NONE, dtype=_I64, device=dev_)
    act = torch.arange(L, dtype=_I64, device=dev_)
    for ftotal in range(recurse_tries):
        if not act.numel():
            break
        r = parent_r[act] + (rep + numrep * ftotal)
        item, status, _ = _descend(dt, bidx[act], 0, x[act], r,
                                   torch.full_like(act, pos),
                                   bump=(numrep, ftotal))
        success = (status == _OK) & (~_is_out(weights, item, x[act]))
        out_dev[act[success]] = item[success]
        act = act[(~success) & (status != _SKIP)]
    return out_dev


def _choose_indep(dt, bidx, target_type: int, numrep: int,
                  recurse_to_leaf: bool, tries: int, recurse_tries: int,
                  weights, x, out_size_limit):
    """crush_choose_indep (mapper.c:655-843) per lane: breadth-first,
    positionally stable; failed slots become ITEM_NONE."""
    L = bidx.shape[0]
    dev_ = bidx.device
    R = numrep
    active = torch.arange(R, dtype=_I64, device=dev_)[None, :] \
        < out_size_limit[:, None]
    out = torch.where(active, ITEM_UNDEF, ITEM_NONE).to(_I64)
    out2 = out.clone()
    lanes = _nz((out == ITEM_UNDEF).any(dim=1))
    for ftotal in range(tries):
        if not lanes.numel():
            break
        for rep in range(R):   # collision sees earlier same-round reps
            pend = lanes[out[lanes, rep] == ITEM_UNDEF]
            if not pend.numel():
                continue
            r = rep + numrep * ftotal
            xp = x[pend]
            # choose_args weight-set position is outpos (0 at rule
            # level), NOT rep: only the leaf recursion uses rep
            item, status, r_at = _descend(
                dt, bidx[pend], target_type, xp, torch.full_like(pend, r),
                torch.zeros_like(pend), bump=(numrep, ftotal))
            collide = (out[pend] == item[:, None]).any(dim=1)
            ok = (status == _OK) & (~collide)
            leaf = item
            if recurse_to_leaf:
                need = _nz(ok & (item < 0))
                if need.numel():
                    ldev = _leaf_indep(dt, -1 - item[need], weights,
                                       xp[need], r_at[need], rep, numrep,
                                       recurse_tries, rep)
                    leaf = item.clone()
                    leaf[need] = ldev
                    ok = ok.clone()
                    ok[need] &= ldev != ITEM_NONE
            if target_type == 0:
                ok = ok & (~_is_out(weights, item, xp))
            # a hard failure pins the slot to NONE for good
            pin = (status == _SKIP) & (~ok)
            out[pend[ok], rep] = item[ok]
            out[pend[pin], rep] = ITEM_NONE
            if recurse_to_leaf:
                out2[pend[ok], rep] = leaf[ok]
                out2[pend[pin], rep] = ITEM_NONE
        lanes = lanes[(out[lanes] == ITEM_UNDEF).any(dim=1)]
    out = torch.where(out == ITEM_UNDEF, ITEM_NONE, out)
    out2 = torch.where(out2 == ITEM_UNDEF, ITEM_NONE, out2)
    return out, out2


# ------------------------------------------------------- rule interpreter --

class XlaMapper:
    """Batched do_rule for one CrushMap on one device.

    Usage::

        mapper = XlaMapper(cmap)
        osds = mapper.map_batch(ruleno, xs, result_max, weights)  # [N, R]

    ``weights`` is the device in/out vector ([max_devices] 16.16 fixed,
    like the reference's __u32 *weight argument); results are padded with
    ITEM_NONE.  ``device`` is where the batched mapper runs (the package
    default, the card, when None); ``fast`` overrides the
    ``fastmap_enabled`` option.
    """

    def __init__(self, cmap: CrushMap, choose_args_key: object = None,
                 n_positions: int = 8, device=None,
                 fast: Optional[bool] = None):
        self.cmap = cmap
        self.choose_args_key = choose_args_key
        self.n_positions = n_positions
        self.device = resolve_device(device)
        self.compiled = compile_map(cmap, choose_args_key, n_positions)
        if fast is None:
            fast = bool(_config().get("fastmap_enabled"))
        self._fast_enabled = fast
        self._fast = None                 # lazy FastMapper
        self._fast_unsupported = set()    # rule keys outside fast subset
        self._exact_fallback = None       # lazy NativeMapper/scalar fn
        self.tables = self.compiled.tables(self.device)
        self._twins: Dict[torch.device, "XlaMapper"] = {}

    # -- rule interpretation (steps are static data, lanes are tensors) ----
    def _trace_rule(self, ruleno: int, result_max: int, x, weights):
        """crush_do_rule (mapper.c:900-1105) for every lane of x [L]
        -> [L, result_max] int64, ITEM_NONE padded."""
        cmap, cm, dt = self.cmap, self.compiled, self.tables
        rule = cmap.rules[ruleno]
        t = cmap.tunables
        L = x.shape[0]
        dev_ = x.device

        def put(dst, at, vals, count):
            """dst[l, at[l] + i] = vals[l, i] for i < count[l]; the other
            writes land in dst's spare last column (the reference's
            mode="drop")."""
            i = torch.arange(vals.shape[1], dtype=_I64, device=dev_)[None, :]
            col = torch.where(i < count[:, None], at[:, None] + i,
                              result_max)
            dst[torch.arange(dst.shape[0], dtype=_I64,
                             device=dev_)[:, None], col] = vals

        choose_tries = t.choose_total_tries + 1
        choose_leaf_tries = 0
        vary_r = t.chooseleaf_vary_r
        stable = bool(t.chooseleaf_stable)
        result = torch.full((L, result_max + 1), ITEM_NONE, dtype=_I64,
                            device=dev_)
        rpos = torch.zeros((L,), dtype=_I64, device=dev_)
        # the working vector: (items [L, n], count [L]) per source
        sources: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for op, arg1, arg2 in rule.steps:
            if op == RULE_TAKE:
                ok = (0 <= arg1 < cmap.max_devices) or \
                    (cmap.bucket(arg1) is not None)
                sources = [(torch.full((L, 1), arg1, dtype=_I64,
                                       device=dev_),
                            torch.ones((L,), dtype=_I64, device=dev_))] \
                    if ok else []
            elif op == RULE_SET_CHOOSE_TRIES:
                if arg1 > 0:
                    choose_tries = arg1
            elif op == RULE_SET_CHOOSELEAF_TRIES:
                if arg1 > 0:
                    choose_leaf_tries = arg1
            elif op == RULE_SET_CHOOSE_LOCAL_TRIES:
                if arg1 > 0:
                    raise UnsupportedMapError("local_tries rule step")
            elif op == RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
                if arg1 > 0:
                    raise UnsupportedMapError("local_fallback rule step")
            elif op == RULE_SET_CHOOSELEAF_VARY_R:
                if arg1 >= 0:
                    vary_r = arg1
            elif op == RULE_SET_CHOOSELEAF_STABLE:
                if arg1 >= 0:
                    stable = bool(arg1)
            elif op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSELEAF_FIRSTN,
                        RULE_CHOOSE_INDEP, RULE_CHOOSELEAF_INDEP):
                firstn = op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSELEAF_FIRSTN)
                leaf = op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP)
                numrep = arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif t.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                else:
                    recurse_tries = choose_leaf_tries or 1
                new_items = torch.full((L, result_max + 1), ITEM_NONE,
                                       dtype=_I64, device=dev_)
                osize = torch.zeros((L,), dtype=_I64, device=dev_)
                for items, count in sources:
                    for i in range(items.shape[1]):
                        bid = items[:, i]
                        live = _nz((i < count) & (bid < 0))
                        if not live.numel():
                            continue
                        bidx = -1 - bid[live]
                        room = result_max - osize[live]
                        if firstn:
                            o, o2, got = _choose_firstn(
                                dt, bidx, arg2, numrep, leaf, choose_tries,
                                recurse_tries, vary_r, stable, weights,
                                x[live], count_limit=room)
                        else:
                            got = room.clamp(max=numrep)
                            o, o2 = _choose_indep(
                                dt, bidx, arg2, numrep, leaf, choose_tries,
                                recurse_tries, weights, x[live],
                                out_size_limit=got)
                        sub = new_items[live]
                        put(sub, osize[live], o2 if leaf else o, got)
                        new_items[live] = sub
                        osize[live] += got
                sources = [(new_items[:, :result_max], osize)]
            elif op == RULE_EMIT:
                for items, count in sources:
                    take = torch.minimum(count, result_max - rpos)
                    put(result, rpos, items, take)
                    rpos = rpos + take
                sources = []
        return result[:, :result_max]

    def _exact_rows(self, ruleno: int, xs_rows, result_max: int, weights):
        """Bit-exact recompute for the fast mapper's incomplete lanes: the
        native C++ interpreter when buildable, else the scalar mapper."""
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

    def _on(self, device: torch.device) -> "XlaMapper":
        """This mapper's tables on ``device``: itself on its own device,
        else a twin built there once (a mesh cell maps on its device)."""
        if device == self.tables.items.device:
            return self
        if device not in self._twins:
            self._twins[device] = XlaMapper(
                self.cmap, choose_args_key=self.choose_args_key,
                n_positions=self.n_positions, device=device,
                fast=self._fast_enabled)
        return self._twins[device]

    def map_batch(self, ruleno: int, xs, result_max: int,
                  weights: Sequence[int], mesh=None) -> np.ndarray:
        """[N] x values -> [N, result_max] i32 osd ids (ITEM_NONE padded).

        With ``mesh`` the lanes split flat, row-major, over the mesh's
        cells (the multi-device ParallelPGMapper): N pads to the mesh
        size, each cell maps its block on its own device, and a fleet
        all-gathers the lanes; the result equals the run without one.

        Dispatch: the level-synchronous FastMapper maps supported rules
        (its incomplete lanes recomputed bit-exactly on the host); rules
        outside its subset, and every rule when ``fastmap_enabled`` is
        off, run the general per-lane trace on the device in chunks of
        ``mapper_max_lanes_per_call`` lanes, read back once."""
        if ruleno < 0 or ruleno >= self.cmap.max_rules or \
                self.cmap.rules[ruleno] is None:
            raise ValueError(f"no rule {ruleno}")
        pc = _perf("crush.mapper")
        pc.inc("map_batch_calls")
        pc.inc("lanes", len(xs))
        fkey = (ruleno, result_max)
        if self._fast_enabled and fkey not in self._fast_unsupported:
            try:
                if self._fast is None:
                    from .fast_mapper import FastMapper
                    self._fast = FastMapper(
                        self.cmap, choose_args_key=self.choose_args_key,
                        device=self.device)
                _mark_active("dispatched_device",
                             component="crush.fastmap", lanes=len(xs))
                with pc.time("fast_map_s"), \
                        _tracing.start_span("crush.fastmap"):
                    out, inc = self._fast.map_batch(
                        ruleno, xs, result_max, weights, mesh=mesh)
                # inc is fast_mapper's host readback (numpy), not a
                # tensor: no sync here
                if inc.any():  # noqa: CTL102
                    rows = np.flatnonzero(inc)
                    pc.inc("fallback_lanes", len(rows))
                    xs_np = np.asarray(xs, dtype=np.int64)[rows]
                    with _tracing.start_span("crush.native_fallback",
                                             lanes=len(rows)):
                        out[rows] = self._exact_rows(
                            ruleno, xs_np, result_max, weights)
                return out
            except UnsupportedMapError:
                self._fast_unsupported.add(fkey)
                pc.inc("fast_unsupported_rules")
        _mark_active("dispatched_device", component="crush.mapper",
                     lanes=len(xs))
        w = np.zeros(self.compiled.max_devices, dtype=np.int64)
        w_in = np.asarray(weights, dtype=np.int64)
        w[:min(len(w_in), len(w))] = w_in[:len(w)]
        xs_np = np.asarray(xs, dtype=np.int64).astype(np.uint32) \
            .astype(np.int64)
        n = len(xs_np)
        if n == 0:
            return np.zeros((0, result_max), dtype=np.int32)
        cap = int(_config().get("mapper_max_lanes_per_call"))
        if mesh is not None:
            cap *= mesh.size
            pad = (-n) % cap if n > cap else (-n) % mesh.size
            xs_np = np.concatenate([xs_np, xs_np[:1].repeat(pad)])
        with pc.time("general_map_s"):
            w_dev = torch.as_tensor(w, device=self.device)
            x_dev = torch.as_tensor(xs_np, device=self.device)

            def trace(lanes):
                if mesh is None:
                    return self._trace_rule(ruleno, result_max, lanes, w_dev)
                from ..parallel.mesh import map_lanes
                return map_lanes(mesh, lambda blk: (self._on(
                    blk.device)._trace_rule(ruleno, result_max, blk,
                                            w_dev.to(blk.device)),),
                    lanes)[0]

            parts = [trace(x_dev[i:i + cap])
                     for i in range(0, len(xs_np), cap)]
            out_d = parts[0] if len(parts) == 1 else torch.cat(parts)
            # the one readback of the general sweep
            return out_d[:n].cpu().numpy().astype(  # noqa: CTL101
                np.int32)
