"""Level-synchronous batched CRUSH mapping — the fast mapper, in torch.

Port of ``ceph_tpu/placement/fast_mapper.py``.  The mapper is batched
torch code on the mapper's device (the card unless the caller asks for
the CPU).  It rests on two facts about the algorithm (reference:
src/crush/mapper.c:460-843):

  1. A descent's value depends only on (map, x, r) — collision/out
     rejections affect which descents are *kept*, never what they
     *return*.  So all retry candidates r in [0, numrep+extra) are
     computed at once as one extra parallel axis, and the sequential
     accept/reject bookkeeping (crush_choose_firstn's ftotal loop,
     crush_choose_indep's rounds) collapses to an unrolled chain of cheap
     [N]-wide integer selects.  Within one replica slot, try number f
     always uses r = rep + f (firstn) or r = rep + numrep*f (indep), so
     the candidate grid is static.
  2. The hierarchy is layered: a descent from one root can only visit
     buckets reachable at that depth.  Tables are therefore built per
     level, so a 1000-host root costs S=1000-wide straw2 draws only at
     level 0 while the host level pays S=10 — not the global max.

Every straw2 draw is computed EXACTLY for every item: the reference's
float64 quotient with its +-1 corrections (xla_mapper.py:388-391) over
the 65,536-entry numerator table.  The reference's f32 prefilter
(``_approx_numer_f32``) only prunes exact evaluations on a TPU and would
need an error margin measured per backend; the card has native f64 and
64-bit gathers, so it is not ported.  The results are bit-identical, and
the lanes this mapper flags incomplete are a subset of the reference's
(it never flags a lane for an ambiguous approximate draw).

Lanes that exhaust the candidate budget (or hit the rare position-
dependent cases the grid cannot represent, e.g. a skip under
chooseleaf_stable=0 or multi-position choose_args weight sets) are
flagged incomplete and recomputed bit-exactly by the caller through the
native C++ interpreter (native_bridge) or the scalar mapper — the
reference's own design, counted as ``fallback_lanes``.

Supported rules: sequences of TAKE/SET_*/CHOOSE*/EMIT where each TAKE
names a static bucket and each take block contains at most one choose
step.  Map subset: straw2 + modern tunables, as compile_map enforces.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..common import tracer as _tracing
from ..common.options import config as _config
from ..ops import hashing
from .crush_map import (
    ITEM_NONE, ITEM_UNDEF,
    RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP, RULE_CHOOSE_FIRSTN,
    RULE_CHOOSE_INDEP, RULE_EMIT, RULE_SET_CHOOSELEAF_STABLE,
    RULE_SET_CHOOSELEAF_TRIES, RULE_SET_CHOOSELEAF_VARY_R,
    RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES, RULE_SET_CHOOSE_LOCAL_TRIES,
    RULE_SET_CHOOSE_TRIES, RULE_TAKE, CrushMap,
)
from .xla_mapper import (
    CompiledMap, DeviceTables, UnsupportedMapError, _is_out,
    _straw2_select, compile_map)

_OK, _REJECT, _SKIP = 0, 1, 2
_I64 = torch.int64

# live [rows, level width] 8-byte buffers of one descent level at its
# peak: the rjenkins hash chain's five state words plus temporaries, the
# numerator and the quotient (the lane-chunk budget divides by this)
_LEVEL_BUFFERS = 8


class UnsupportedRuleError(UnsupportedMapError):
    """Rule shape outside the fast subset."""


# ------------------------------------------------------------ level tables --

@dataclass
class _HostLevel:
    """One descent level, host-side (rows = buckets reachable here)."""
    bucket_ids: List[int]            # global bucket ids at this level
    items: np.ndarray                # i32 [Bl, Sl] child ids
    hash_ids: np.ndarray             # i32 [Bl, Sl]
    weights: np.ndarray              # i32 [Bl, P, Sl]
    sizes: np.ndarray                # i32 [Bl]
    child_row: np.ndarray            # i32 [Bl, Sl] row in next level (-1)
    child_type: np.ndarray           # i32 [Bl, Sl] (0 for devices)
    child_escape: np.ndarray         # bool [Bl, Sl] invalid child
    child_leafrow: np.ndarray        # i32 [Bl, Sl] row in leaf class (-1)


def _build_levels(cmap: CrushMap, cm: CompiledMap, roots: List[int],
                  target_type: int) -> Tuple[List[_HostLevel], List[int]]:
    """BFS the hierarchy from `roots` down to `target_type`.

    Returns (levels, leaf_class): leaf_class is the ordered list of
    target-type bucket ids encountered (the chooseleaf recursion roots).
    """
    levels: List[_HostLevel] = []
    leaf_class: List[int] = []
    leaf_index: Dict[int, int] = {}
    cur = list(dict.fromkeys(roots))
    for _ in range(cm.max_depth + 1):
        if not cur:
            break
        next_ids: List[int] = []
        next_index: Dict[int, int] = {}
        rows = [cmap.bucket(b) for b in cur]
        Sl = max((b.size for b in rows if b is not None), default=1)
        Sl = max(Sl, 1)
        Bl = len(cur)
        items = np.zeros((Bl, Sl), dtype=np.int32)
        hash_ids = np.zeros((Bl, Sl), dtype=np.int32)
        ws = np.zeros((Bl, cm.n_positions, Sl), dtype=np.int32)
        sizes = np.zeros(Bl, dtype=np.int32)
        child_row = np.full((Bl, Sl), -1, dtype=np.int32)
        child_type = np.zeros((Bl, Sl), dtype=np.int32)
        child_escape = np.zeros((Bl, Sl), dtype=bool)
        child_leafrow = np.full((Bl, Sl), -1, dtype=np.int32)
        for li, (bid, b) in enumerate(zip(cur, rows)):
            if b is None:
                continue
            gidx = -1 - bid
            n = b.size
            sizes[li] = n
            items[li, :n] = cm.items[gidx, :n]
            hash_ids[li, :n] = cm.hash_ids[gidx, :n]
            ws[li, :, :n] = cm.weight_sets[gidx, :, :n]
            for s, c in enumerate(b.items):
                if c >= 0:
                    if c >= cm.max_devices:
                        child_escape[li, s] = True
                    continue
                cb = cmap.bucket(c)
                if cb is None:
                    child_escape[li, s] = True
                    continue
                child_type[li, s] = cb.type
                if cb.type == target_type:
                    if c not in leaf_index:
                        leaf_index[c] = len(leaf_class)
                        leaf_class.append(c)
                    child_leafrow[li, s] = leaf_index[c]
                else:
                    if c not in next_index:
                        next_index[c] = len(next_ids)
                        next_ids.append(c)
                    child_row[li, s] = next_index[c]
        levels.append(_HostLevel(
            bucket_ids=list(cur), items=items, hash_ids=hash_ids,
            weights=ws, sizes=sizes, child_row=child_row,
            child_type=child_type, child_escape=child_escape,
            child_leafrow=child_leafrow))
        cur = next_ids
    if cur:
        raise UnsupportedMapError(
            "hierarchy deeper than max_depth (cycle?)")
    return levels, leaf_class


class _DevLevel:
    """Level tables on the mapper's device for one static choose_args
    position (row gathers; weights kept whole as int64 16.16 values)."""

    def __init__(self, hl: _HostLevel, pos: int, device: torch.device):
        self.Bl, self.Sl = hl.items.shape
        pos_c = min(pos, hl.weights.shape[1] - 1)

        def t(a, dtype=_I64):
            return torch.as_tensor(np.ascontiguousarray(a), device=device) \
                .to(dtype)

        self.items = t(hl.items)
        self.hash_ids = t(hl.hash_ids)
        self.weights = t(hl.weights[:, pos_c, :])
        self.sizes = t(hl.sizes)
        self.child_row = t(hl.child_row)
        self.child_type = t(hl.child_type)
        self.child_escape = t(hl.child_escape, torch.bool)
        self.child_leafrow = t(hl.child_leafrow)

    def rows(self, row: torch.Tensor):
        """row [L] -> (items, ids, weights, sizes, child_row, child_type,
        child_escape, child_leafrow); [L, Sl] each except sizes [L]."""
        tabs = (self.items, self.hash_ids, self.weights, self.sizes,
                self.child_row, self.child_type, self.child_escape,
                self.child_leafrow)
        if self.Bl == 1:
            # single-bucket level (every TAKE root): a broadcast view of
            # the row, no [L, S] copy
            L = row.shape[0]
            return tuple(a[0].expand((L,) + tuple(a.shape[1:]))
                         for a in tabs)
        r = row.clamp(0, self.Bl - 1)
        return tuple(a[r] for a in tabs)

    @staticmethod
    def select(j: torch.Tensor, *tables):
        """tables[i][l, j[l]] for each [L, Sl] table."""
        jj = j[:, None]
        return tuple(torch.take_along_dim(t, jj, dim=1)[:, 0] for t in tables)


# ---------------------------------------------------------------- descent ---

def _descend_batch(levels: List[_DevLevel], dt: DeviceTables,
                   target_type: int, row0, x, r, want_leafrow: bool):
    """Batched hierarchy walk: row0/x/r are [L]; returns
    (item [L], status [L], leafrow [L]).  Unrolled over levels; every
    level is one straw2 selection over that level's width."""
    L = x.shape[0]
    dev = x.device
    cur = row0.clamp(min=0)
    done = row0 < 0
    status = torch.where(done, torch.full_like(row0, _SKIP),
                         torch.full_like(row0, _REJECT))
    result = torch.full((L,), ITEM_NONE, dtype=_I64, device=dev)
    leafrow = torch.full((L,), -1, dtype=_I64, device=dev)
    for lvl in levels:
        (items, ids, w, sizes, child_row, child_type, child_escape,
         child_leafrow) = lvl.rows(cur)
        empty = sizes == 0
        u = hashing.jx_hash3(x[:, None], ids, r[:, None]) & 0xFFFF
        j = _straw2_select(dt, u, w, sizes)
        item, ctype, nrow, esc, lrow = lvl.select(
            j, items, child_type, child_row, child_escape, child_leafrow)
        is_dev = item >= 0
        match = ctype == target_type
        lvl_reject = empty
        lvl_skip = (~empty) & (esc | ((~match) & is_dev))
        lvl_done = lvl_reject | lvl_skip | ((~empty) & match & (~esc))
        new_status = torch.where(
            lvl_reject, _REJECT,
            torch.where(lvl_skip, _SKIP, torch.where(match, _OK, status)))
        status = torch.where(done, status, new_status)
        keep = done | (~match) | empty | esc
        result = torch.where(keep, result, item)
        if want_leafrow:
            leafrow = torch.where(keep, leafrow, lrow)
        new_done = done | lvl_done
        cur = torch.where(new_done, cur, nrow)
        done = new_done
    status = torch.where(done, status, torch.full_like(status, _SKIP))
    return result, status, leafrow


# ------------------------------------------------------------- choose step --

@dataclass(frozen=True)
class _ChooseSpec:
    """Static description of one choose step inside a take block."""
    firstn: bool
    leaf: bool
    numrep: int
    target_type: int
    tries: int               # choose_total_tries + 1 (or rule override)
    recurse_tries: int
    vary_r: int
    stable: bool
    root: int                # static bucket id


class _FastChoose:
    """Candidate grids + unrolled resolve for one choose step."""

    def __init__(self, cmap: CrushMap, cm: CompiledMap, dt: DeviceTables,
                 spec: _ChooseSpec, extra: int, device: torch.device):
        self.spec = spec
        self.dt = dt
        self.device = device
        self.max_devices = cm.max_devices
        self.P = cm.n_positions
        levels_h, leaf_class = _build_levels(
            cmap, cm, [spec.root], spec.target_type)
        # The compact [N, R] candidate grid models the weight-set
        # position as 0 and (for stable chooseleaf) the leaf rep_base as
        # 0.  That is exact when P == 1 (all positions identical) and
        # stable=1.  Otherwise candidates are per (rep, f) with pos=rep
        # assuming outpos == rep; a prior skip breaks the assumption and
        # flags the lane for exact recompute.
        self.per_rep = spec.firstn and (
            self.P > 1 or (spec.leaf and not spec.stable))
        if spec.firstn:
            self.R = spec.numrep + extra
            self.rounds = 0
        else:
            # indep reuses slot-r candidates across rounds, and late slots
            # collide with probability ~(numrep/domains) per round: the
            # round budget needs a floor independent of the firstn extra,
            # but never beyond the rule's try budget (a round the
            # reference would not attempt could fill a slot it leaves NONE)
            self.rounds = min(spec.tries, max(5, 1 + extra // 2))
            self.R = spec.numrep * self.rounds
        par_pos = list(range(spec.numrep)) if self.per_rep else [0]
        self.levels = {p: [_DevLevel(h, p, device) for h in levels_h]
                       for p in par_pos}
        # leaf positions: firstn uses pos=outpos (grid: rep or 0); indep
        # leaf uses pos=rep — per-rep tables only needed when P>1
        self.leaf_levels: Dict[int, list] = {}
        self.has_leaf = bool(spec.leaf and leaf_class)
        if self.has_leaf:
            lh, sub = _build_levels(cmap, cm, leaf_class, 0)
            if sub:
                raise UnsupportedMapError(
                    "chooseleaf targets nest buckets of the same type")
            if spec.firstn:
                leaf_pos = par_pos
            else:
                leaf_pos = list(range(spec.numrep)) if self.P > 1 else [0]
            self.leaf_levels = {
                p: [_DevLevel(h, p, device) for h in lh] for p in leaf_pos}

    # ---- candidate grids -------------------------------------------------
    def _descend_grid(self, levels, target_type, x, row0, rvals,
                      want_leafrow, cands):
        """x [N]; row0/rvals [N, K] -> (item, status, leafrow), each
        [N, K].  ``cands`` (parent or leaf) tags its span."""
        N, K = rvals.shape
        with _tracing.child_span("crush.fastmap.descend", cands=cands,
                                 levels=len(levels), on_device=x.device):
            xg = x.repeat_interleave(K)
            item, status, leafrow = _descend_batch(
                levels, self.dt, target_type, row0.reshape(-1), xg,
                rvals.reshape(-1), want_leafrow)
        return (item.reshape(N, K), status.reshape(N, K),
                leafrow.reshape(N, K))

    def parent_cands(self, x):
        """-> (item, status, leafrow) each [N, G, R]."""
        spec = self.spec
        N = x.shape[0]
        groups = list(range(spec.numrep)) if self.per_rep else [0]
        rvals = torch.arange(self.R, dtype=_I64,
                             device=x.device).expand(N, self.R)
        row0 = torch.zeros((N, self.R), dtype=_I64, device=x.device)
        outs = [self._descend_grid(self.levels[g], spec.target_type, x,
                                   row0, rvals, self.has_leaf, "parent")
                for g in groups]
        return tuple(torch.stack([o[i] for o in outs], dim=1)
                     for i in range(3))

    def leaf_cands(self, x, p_leafrow):
        """Leaf grids per parent candidate: [N, G, R, F'] (dev, status).

        p_leafrow: [N, G, R].  The leaf r depends on the parent slot:
        firstn: r' = rep_base + sub_r + ft (rep_base 0 when stable, rep
        when per-rep); indep: r' = rep + r_parent + numrep*ft with
        rep = r_parent mod numrep (slots are unique per rep).
        """
        spec = self.spec
        N, G, R = p_leafrow.shape
        dev_ = x.device
        rs = torch.arange(R, dtype=_I64, device=dev_)
        devs, sts = [], []
        for g in range(G):
            row0 = p_leafrow[:, g]                       # [N, R]
            gdevs, gsts = [], []
            for ft in range(spec.recurse_tries):
                if spec.firstn:
                    sub_r = (rs >> (spec.vary_r - 1)) if spec.vary_r \
                        else torch.zeros_like(rs)
                    rep_base = g if (self.per_rep and not spec.stable) \
                        else 0
                    r_leaf = (rep_base + sub_r + ft).expand(N, R)
                    lv = self.leaf_levels[g if self.per_rep else 0]
                    dev, st, _ = self._descend_grid(
                        lv, 0, x, row0, r_leaf, False, "leaf")
                else:
                    # indep: rep = slot mod numrep; one sub-grid per rep
                    # so each slot gets its rep-dependent r and (P>1) its
                    # rep-positioned weight tables
                    dev = torch.full((N, R), ITEM_NONE, dtype=_I64,
                                     device=dev_)
                    st = torch.full((N, R), _SKIP, dtype=_I64, device=dev_)
                    for rep in range(spec.numrep):
                        slots = list(range(rep, R, spec.numrep))
                        if not slots:
                            continue
                        sl = torch.tensor(slots, dtype=_I64, device=dev_)
                        r_leaf = (rep + sl + spec.numrep * ft) \
                            .expand(N, len(slots))
                        lv = self.leaf_levels[rep if self.P > 1 else 0]
                        d, s, _ = self._descend_grid(
                            lv, 0, x, row0[:, sl], r_leaf, False, "leaf")
                        dev[:, sl] = d
                        st[:, sl] = s
                gdevs.append(dev)
                gsts.append(st)
            devs.append(torch.stack(gdevs, -1))
            sts.append(torch.stack(gsts, -1))
        return torch.stack(devs, 1), torch.stack(sts, 1)

    # ---- execution -------------------------------------------------------
    def run(self, x, weights, count_limit: int):
        """count_limit: static int (result_max at rule level).
        -> (out [N,numrep], out2, got [N], incomplete [N])."""
        spec = self.spec
        N = x.shape[0]
        p_item, p_status, p_leafrow = self.parent_cands(x)
        if spec.leaf:
            if self.has_leaf:
                l_dev, l_st = self.leaf_cands(x, p_leafrow)
            else:
                shape = tuple(p_item.shape) + (spec.recurse_tries,)
                l_dev = torch.full(shape, ITEM_NONE, dtype=_I64,
                                   device=x.device)
                l_st = torch.full(shape, _SKIP, dtype=_I64, device=x.device)
        with _tracing.child_span("crush.fastmap.resolve",
                                 on_device=x.device):
            leaf_pack = None
            if spec.leaf:
                l_out = _is_out(
                    weights, l_dev.reshape(-1),
                    x.repeat_interleave(l_dev.numel() // N)) \
                    .reshape(l_dev.shape)
                leaf_pack = (l_dev, l_st, l_out)
            if spec.target_type == 0:
                p_out = _is_out(
                    weights, p_item.reshape(-1),
                    x.repeat_interleave(p_item.numel() // N)) \
                    .reshape(p_item.shape)
            else:
                p_out = torch.zeros(p_item.shape, dtype=torch.bool,
                                    device=x.device)
            if spec.firstn:
                return self._resolve_firstn(p_item, p_status, p_out,
                                            leaf_pack, count_limit)
            return self._resolve_indep(p_item, p_status, p_out, leaf_pack,
                                       count_limit)

    def _leaf_resolve(self, leaf_pack, g, r, out2, outpos, windowed):
        """Walk the leaf retry chain for slot (g, r) against current
        out2 state -> (leaf_dev [N], leaf_ok [N])."""
        l_dev, l_st, l_is_out = leaf_pack
        N = l_dev.shape[0]
        dev_ = l_dev.device
        slot_ids = torch.arange(out2.shape[1], dtype=_I64, device=dev_)
        ldev = torch.full((N,), ITEM_NONE, dtype=_I64, device=dev_)
        lok = torch.zeros((N,), dtype=torch.bool, device=dev_)
        ldone = torch.zeros((N,), dtype=torch.bool, device=dev_)
        for ft in range(l_dev.shape[-1]):
            d = l_dev[:, g, r, ft]
            st = l_st[:, g, r, ft]
            lo = l_is_out[:, g, r, ft]
            if windowed:
                lcol = ((slot_ids[None, :] < outpos[:, None]) &
                        (out2 == d[:, None])).any(dim=1)
            else:
                lcol = torch.zeros((N,), dtype=torch.bool, device=dev_)
            succ = (~ldone) & (st == _OK) & (~lcol) & (~lo)
            hard = (~ldone) & (st == _SKIP)
            ldev = torch.where(succ, d, ldev)
            lok = lok | succ
            ldone = ldone | succ | hard
        return ldev, lok

    def _resolve_firstn(self, p_item, p_status, p_out, leaf_pack,
                        count_limit: int):
        spec = self.spec
        N = p_item.shape[0]
        dev_ = p_item.device
        R_out = spec.numrep
        NONE = torch.full((N,), ITEM_NONE, dtype=_I64, device=dev_)
        out = torch.full((N, R_out), ITEM_NONE, dtype=_I64, device=dev_)
        out2 = out.clone()
        outpos = torch.zeros((N,), dtype=_I64, device=dev_)
        incomplete = torch.zeros((N,), dtype=torch.bool, device=dev_)
        slot_ids = torch.arange(R_out, dtype=_I64, device=dev_)
        for rep in range(spec.numrep):
            g = rep if self.per_rep else 0
            placed = torch.zeros((N,), dtype=torch.bool, device=dev_)
            skipped = torch.zeros((N,), dtype=torch.bool, device=dev_)
            item_sel = NONE
            leaf_sel = NONE
            budget = self.R - rep
            for f in range(min(budget, spec.tries)):
                r = rep + f
                item = p_item[:, g, r]
                status = p_status[:, g, r]
                collide = ((slot_ids[None, :] < outpos[:, None]) &
                           (out == item[:, None])).any(dim=1)
                reject = status == _REJECT
                if spec.leaf:
                    ldev, lok = self._leaf_resolve(
                        leaf_pack, g, r, out2, outpos, windowed=True)
                    is_bucket = item < 0
                    leaf_val = torch.where(is_bucket, ldev, item)
                    reject = reject | (
                        (status == _OK) & (~collide) & is_bucket & (~lok))
                else:
                    leaf_val = NONE
                if spec.target_type == 0:
                    reject = reject | (
                        (status == _OK) & (~collide) & p_out[:, g, r])
                ok = (status == _OK) & (~collide) & (~reject)
                skip = status == _SKIP
                active = (~placed) & (~skipped)
                place_now = active & ok
                item_sel = torch.where(place_now, item, item_sel)
                if spec.leaf:
                    leaf_sel = torch.where(place_now, leaf_val, leaf_sel)
                placed = placed | place_now
                skipped = skipped | (active & skip)
            if budget < spec.tries:
                incomplete = incomplete | ((~placed) & (~skipped))
            if self.per_rep:
                # grids assumed outpos == rep (pos / leaf rep_base)
                incomplete = incomplete | (placed & (outpos != rep))
            do_place = placed & (outpos < count_limit)
            sel = do_place[:, None] & (slot_ids[None, :] == outpos[:, None])
            out = torch.where(sel, item_sel[:, None], out)
            if spec.leaf:
                out2 = torch.where(sel, leaf_sel[:, None], out2)
            outpos = outpos + do_place.to(_I64)
        return out, out2, outpos, incomplete

    def _resolve_indep(self, p_item, p_status, p_out, leaf_pack,
                       count_limit: int):
        spec = self.spec
        N = p_item.shape[0]
        dev_ = p_item.device
        R_out = spec.numrep
        limit = min(spec.numrep, count_limit)
        NONE = torch.full((N,), ITEM_NONE, dtype=_I64, device=dev_)
        active = (torch.arange(R_out, dtype=_I64, device=dev_)
                  < limit).expand(N, R_out)
        out = torch.full((N, R_out), ITEM_NONE, dtype=_I64, device=dev_)
        out[:, :limit] = ITEM_UNDEF
        out2 = out.clone()
        dummy_pos = torch.zeros((N,), dtype=_I64, device=dev_)
        no = torch.zeros((N,), dtype=torch.bool, device=dev_)
        for f in range(self.rounds):      # already capped at spec.tries
            for rep in range(min(spec.numrep, limit)):
                r = rep + spec.numrep * f
                if r >= self.R:
                    continue
                item = p_item[:, 0, r]
                status = p_status[:, 0, r]
                pending = active[:, rep] & (out[:, rep] == ITEM_UNDEF)
                collide = (out == item[:, None]).any(dim=1)
                hard = status == _SKIP
                if spec.leaf:
                    ldev, _ = self._leaf_resolve(
                        leaf_pack, 0, r, out2, dummy_pos, windowed=False)
                    is_bucket = item < 0
                    leaf_val = torch.where(is_bucket, ldev, item)
                    leaf_fail = is_bucket & (ldev == ITEM_NONE)
                else:
                    leaf_val = NONE
                    leaf_fail = no
                out_dev = ((status == _OK) & p_out[:, 0, r]) \
                    if spec.target_type == 0 else no
                ok = (status == _OK) & (~collide) & (~leaf_fail) & \
                    (~out_dev)
                place = pending & ok
                pin = pending & hard & (~ok)
                out[:, rep] = torch.where(
                    place, item, torch.where(pin, NONE, out[:, rep]))
                out2[:, rep] = torch.where(
                    place, leaf_val, torch.where(pin, NONE, out2[:, rep]))
        incomplete = (out == ITEM_UNDEF).any(dim=1) \
            if self.rounds < spec.tries else no
        out = torch.where(out == ITEM_UNDEF, NONE[:, None], out)
        out2 = torch.where(out2 == ITEM_UNDEF, NONE[:, None], out2)
        got = torch.full((N,), limit, dtype=_I64, device=dev_)
        return out, out2, got, incomplete


# ------------------------------------------------------ rule interpreter ---

class FastMapper:
    """Candidate-parallel batched do_rule for one CrushMap, on one device.

    map_batch returns (results [N, result_max], incomplete [N]): lanes
    flagged incomplete must be recomputed by a bit-exact host mapper (the
    native C++ mapper or the scalar mapper).
    """

    def __init__(self, cmap: CrushMap, choose_args_key: object = None,
                 extra_tries: Optional[int] = None, device=None):
        self.cmap = cmap
        self.choose_args_key = choose_args_key
        self.device = resolve_device(device)
        self.compiled = compile_map(cmap, choose_args_key, n_positions=1)
        if not self.compiled.all_straw2:
            raise UnsupportedMapError(
                "fast mapper vectorizes straw2 buckets only; legacy "
                "algs run through the general mapper")
        self.dt = self.compiled.tables(self.device)
        if extra_tries is None:
            extra_tries = int(_config().get("fastmap_extra_tries"))
        self.extra = max(2, extra_tries)
        self._plans: Dict[Tuple[int, int], list] = {}
        self._twins: Dict[torch.device, "FastMapper"] = {}

    def _on(self, device: torch.device) -> "FastMapper":
        """This mapper's tables on ``device``: itself on its own device,
        else a twin built there once (a mesh cell maps on its device)."""
        if device == self.dt.items.device:
            return self
        if device not in self._twins:
            self._twins[device] = FastMapper(
                self.cmap, choose_args_key=self.choose_args_key,
                extra_tries=self.extra, device=device)
        return self._twins[device]

    # ---- host-side rule analysis ----------------------------------------
    def _plan(self, ruleno: int, result_max: int) -> list:
        """Parse the rule into a static plan:
        ("choose", _FastChoose) | ("choose_dead",) | ("emit_take", item)
        | ("emit",)."""
        key = (ruleno, result_max)
        if key in self._plans:
            return self._plans[key]
        cmap = self.cmap
        t = cmap.tunables
        rule = cmap.rules[ruleno]
        choose_tries = t.choose_total_tries + 1
        choose_leaf_tries = 0
        vary_r = t.chooseleaf_vary_r
        stable = bool(t.chooseleaf_stable)
        plan = []
        pending_take: Optional[int] = None
        took_choose = False
        for op, arg1, arg2 in rule.steps:
            if op == RULE_TAKE:
                pending_take = arg1
                took_choose = False
            elif op == RULE_SET_CHOOSE_TRIES:
                if arg1 > 0:
                    choose_tries = arg1
            elif op == RULE_SET_CHOOSELEAF_TRIES:
                if arg1 > 0:
                    choose_leaf_tries = arg1
            elif op in (RULE_SET_CHOOSE_LOCAL_TRIES,
                        RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES):
                if arg1 > 0:
                    raise UnsupportedMapError("local_tries rule step")
            elif op == RULE_SET_CHOOSELEAF_VARY_R:
                if arg1 >= 0:
                    vary_r = arg1
            elif op == RULE_SET_CHOOSELEAF_STABLE:
                if arg1 >= 0:
                    stable = bool(arg1)
            elif op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSELEAF_FIRSTN,
                        RULE_CHOOSE_INDEP, RULE_CHOOSELEAF_INDEP):
                if took_choose:
                    raise UnsupportedRuleError(
                        "chained choose steps (choose feeding choose)")
                took_choose = True
                firstn = op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSELEAF_FIRSTN)
                leaf = op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP)
                numrep = arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        took_choose = False
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
                if recurse_tries > 4:
                    raise UnsupportedRuleError(
                        f"recurse_tries {recurse_tries} too large for "
                        "the candidate grid")
                if pending_take is None or pending_take >= 0 or \
                        cmap.bucket(pending_take) is None:
                    plan.append(("choose_dead",))
                    continue
                spec = _ChooseSpec(
                    firstn=firstn, leaf=leaf, numrep=numrep,
                    target_type=arg2, tries=choose_tries,
                    recurse_tries=recurse_tries, vary_r=vary_r,
                    stable=stable, root=pending_take)
                plan.append(("choose", _FastChoose(
                    cmap, self.compiled, self.dt, spec, self.extra,
                    self.device)))
            elif op == RULE_EMIT:
                if not took_choose and pending_take is not None:
                    ok = (0 <= pending_take < cmap.max_devices) or \
                        (cmap.bucket(pending_take) is not None)
                    plan.append(("emit_take",
                                 pending_take if ok else None))
                else:
                    plan.append(("emit",))
                pending_take = None
                took_choose = False
            else:
                raise UnsupportedRuleError(f"rule op {op}")
        self._plans[key] = plan
        return plan

    def _trace(self, plan, result_max: int, x, weights):
        N = x.shape[0]
        dev_ = x.device
        result = torch.full((N, result_max), ITEM_NONE, dtype=_I64,
                            device=dev_)
        rpos = torch.zeros((N,), dtype=_I64, device=dev_)
        incomplete = torch.zeros((N,), dtype=torch.bool, device=dev_)
        res_ids = torch.arange(result_max, dtype=_I64, device=dev_)
        pend_out = None            # (vals [N, n], count [N]) awaiting emit
        for entry in plan:
            kind = entry[0]
            if kind == "choose":
                fc: _FastChoose = entry[1]
                out, out2, got, inc = fc.run(x, weights, result_max)
                incomplete = incomplete | inc
                pend_out = (out2 if fc.spec.leaf else out, got)
            elif kind == "choose_dead":
                pend_out = (torch.full((N, 1), ITEM_NONE, dtype=_I64,
                                       device=dev_),
                            torch.zeros((N,), dtype=_I64, device=dev_))
            elif kind == "emit_take":
                if entry[1] is None:
                    pend_out = None
                    continue
                can = rpos < result_max
                sel = can[:, None] & (res_ids[None, :] == rpos[:, None])
                result = torch.where(sel, entry[1], result)
                rpos = rpos + can.to(_I64)
                pend_out = None
            else:   # emit
                if pend_out is None:
                    continue
                vals, count = pend_out
                with _tracing.child_span("crush.fastmap.emit",
                                         on_device=dev_):
                    for i in range(vals.shape[1]):
                        ok = (i < count) & (rpos < result_max)
                        sel = ok[:, None] & \
                            (res_ids[None, :] == rpos[:, None])
                        result = torch.where(sel, vals[:, i:i + 1], result)
                        rpos = rpos + ok.to(_I64)
                pend_out = None
        return result, incomplete

    # ---- public ----------------------------------------------------------
    def grid_width(self, ruleno: int, result_max: int) -> int:
        return max((e[1].R * (e[1].spec.numrep if e[1].per_rep else 1)
                    for e in self._plan(ruleno, result_max)
                    if e[0] == "choose"), default=1)

    def max_level_width(self, ruleno: int, result_max: int) -> int:
        """Widest level table any descent touches (the S in the [rows, S]
        working set)."""
        width = 1
        for e in self._plan(ruleno, result_max):
            if e[0] != "choose":
                continue
            fc: _FastChoose = e[1]
            for levels in list(fc.levels.values()) + \
                    list(fc.leaf_levels.values()):
                for lvl in levels:
                    width = max(width, lvl.Sl)
        return width

    def chunk_lanes(self, ruleno: int, result_max: int) -> int:
        """Lanes per dispatch: candidate grids multiply lane width by
        R*G, and each level keeps ~_LEVEL_BUFFERS [rows, S] 8-byte
        buffers live, so lanes are capped to keep rows*S inside the
        ``fastmap_max_grid_mib`` budget."""
        gw = self.grid_width(ruleno, result_max)
        max_grid = int(_config().get("fastmap_max_grid_lanes"))
        budget_rows_s = int(_config().get("fastmap_max_grid_mib")) \
            * (1 << 20) // (8 * _LEVEL_BUFFERS)
        width = self.max_level_width(ruleno, result_max)
        return max(1 << 10, min(max_grid // gw,
                                budget_rows_s // (gw * width)))

    def map_batch(self, ruleno: int, xs, result_max: int,
                  weights: Sequence[int], mesh=None, readback: bool = True):
        """-> (results [N, result_max] i32, incomplete [N] bool).

        Lanes go through in chunks (``chunk_lanes``) and stay on the
        device until one final readback.  ``readback=False`` returns the
        device tensors (int64 results) instead.

        With ``mesh`` the chunk cap scales by ``mesh.size`` and each
        chunk's lanes split flat, row-major, over the cells
        (``parallel/mesh.map_lanes``): each cell maps its block on its
        own device, a fleet all-gathers the rest.  The lanes pad to the
        cap (or the mesh size) with copies of lane 0, cut off after."""
        if ruleno < 0 or ruleno >= self.cmap.max_rules or \
                self.cmap.rules[ruleno] is None:
            raise ValueError(f"no rule {ruleno}")
        plan = self._plan(ruleno, result_max)      # raise Unsupported early
        w = np.zeros(self.compiled.max_devices, dtype=np.int64)
        w_in = np.asarray(weights, dtype=np.int64)
        w[:min(len(w_in), len(w))] = w_in[:len(w)]
        xs_np = np.asarray(xs, dtype=np.int64).astype(np.uint32) \
            .astype(np.int64)
        n = len(xs_np)
        if n == 0:
            empty = (np.zeros((0, result_max), dtype=np.int32),
                     np.zeros(0, dtype=bool))
            return empty if readback else tuple(
                torch.as_tensor(e, device=self.device) for e in empty)
        cap = self.chunk_lanes(ruleno, result_max)
        if mesh is not None:
            cap *= mesh.size
            pad = (-n) % cap if n > cap else (-n) % mesh.size
            xs_np = np.concatenate([xs_np, xs_np[:1].repeat(pad)])
        with _tracing.child_span("crush.fastmap.upload",
                                 on_device=self.device):
            w_dev = torch.as_tensor(w, device=self.device)
            x_dev = torch.as_tensor(xs_np, device=self.device)

        def cell(block):
            twin = self._on(block.device)
            return twin._trace(twin._plan(ruleno, result_max), result_max,
                               block, w_dev.to(block.device))

        outs, incs = [], []
        for i in range(0, len(xs_np), cap):
            if mesh is None:
                o, inc = self._trace(plan, result_max, x_dev[i:i + cap],
                                     w_dev)
            else:
                from ..parallel.mesh import map_lanes
                o, inc = map_lanes(mesh, cell, x_dev[i:i + cap])
            outs.append(o)
            incs.append(inc)
        out_d = outs[0] if len(outs) == 1 else torch.cat(outs)
        inc_d = incs[0] if len(incs) == 1 else torch.cat(incs)
        out_d, inc_d = out_d[:n], inc_d[:n]
        if not readback:
            return out_d, inc_d
        # the one readback of the sweep: results and the incomplete
        # lanes the caller hands to the native mapper
        with _tracing.child_span(
                "crush.fastmap.readback", on_device=self.device,
                bytes=out_d.numel() * out_d.element_size() +
                inc_d.numel() * inc_d.element_size()):
            return (out_d.cpu().numpy().astype(np.int32),  # noqa: CTL101
                    inc_d.cpu().numpy())  # noqa: CTL101
