"""Bit-exact scalar CRUSH mapper — the correctness oracle for the TPU mapper.

A from-scratch Python implementation of the placement semantics of the
reference interpreter (src/crush/mapper.c): the rule program machine
(crush_do_rule, mapper.c:900-1105), depth-first firstn selection with
collision/out/retry handling (crush_choose_firstn, mapper.c:460-648),
breadth-first positionally-stable indep selection (crush_choose_indep,
mapper.c:655-843), and the five bucket choose algorithms
(mapper.c:73-418).  Everything is pure integer math on Python ints.

This module is deliberately scalar and slow: it exists to define behavior for
tests and to cross-check the batched XLA mapper and the C++ native mapper.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..ops import hashing
from . import lntable
from .crush_map import (
    BUCKET_LIST, BUCKET_STRAW, BUCKET_STRAW2, BUCKET_TREE, BUCKET_UNIFORM,
    ITEM_NONE, ITEM_UNDEF, RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP,
    RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP, RULE_EMIT,
    RULE_SET_CHOOSELEAF_STABLE, RULE_SET_CHOOSELEAF_TRIES,
    RULE_SET_CHOOSELEAF_VARY_R, RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    RULE_SET_CHOOSE_LOCAL_TRIES, RULE_SET_CHOOSE_TRIES, RULE_TAKE,
    Bucket, ChooseArg, CrushMap, tree_left, tree_right,
)

S64_MIN = lntable.S64_MIN


class _PermState:
    """Per-bucket lazily-built random permutation (mapper.c:73-131)."""

    __slots__ = ("perm_x", "perm_n", "perm")

    def __init__(self, size: int):
        self.perm_x = 0
        self.perm_n = 0
        self.perm = [0] * size


class Workspace:
    """Mutable scratch state across one do_rule call (crush_init_workspace)."""

    def __init__(self, cmap: CrushMap):
        self._perm: Dict[int, _PermState] = {}
        for b in cmap.buckets:
            if b is not None:
                self._perm[b.id] = _PermState(b.size)

    def perm(self, bucket_id: int) -> _PermState:
        return self._perm[bucket_id]


# ------------------------------------------------------- bucket choosers ----

def bucket_perm_choose(bucket: Bucket, work: _PermState, x: int, r: int) -> int:
    pr = r % bucket.size
    if work.perm_x != (x & 0xFFFFFFFF) or work.perm_n == 0:
        work.perm_x = x & 0xFFFFFFFF
        if pr == 0:
            s = hashing.hash3(x, bucket.id & 0xFFFFFFFF, 0) % bucket.size
            work.perm[0] = s
            work.perm_n = 0xFFFF  # magic: only slot 0 is valid
            return bucket.items[s]
        work.perm = list(range(bucket.size))
        work.perm_n = 0
    elif work.perm_n == 0xFFFF:
        # expand the r=0 shortcut into a real prefix
        for i in range(1, bucket.size):
            work.perm[i] = i
        work.perm[work.perm[0]] = 0
        work.perm_n = 1
    while work.perm_n <= pr:
        p = work.perm_n
        if p < bucket.size - 1:
            i = hashing.hash3(x, bucket.id & 0xFFFFFFFF, p) % (bucket.size - p)
            if i:
                work.perm[p + i], work.perm[p] = work.perm[p], work.perm[p + i]
        work.perm_n += 1
    return bucket.items[work.perm[pr]]


def bucket_list_choose(bucket: Bucket, x: int, r: int) -> int:
    for i in range(bucket.size - 1, -1, -1):
        w = hashing.hash4(x, bucket.items[i] & 0xFFFFFFFF, r,
                          bucket.id & 0xFFFFFFFF) & 0xFFFF
        w = (w * bucket.sum_weights[i]) >> 16
        if w < bucket.weights[i]:
            return bucket.items[i]
    return bucket.items[0]


def bucket_tree_choose(bucket: Bucket, x: int, r: int) -> int:
    n = bucket.num_nodes >> 1
    while not (n & 1):
        w = bucket.node_weights[n]
        t = (hashing.hash4(x, n, r, bucket.id & 0xFFFFFFFF) * w) >> 32
        l = tree_left(n)
        n = l if t < bucket.node_weights[l] else tree_right(n)
    return bucket.items[n >> 1]


def bucket_straw_choose(bucket: Bucket, x: int, r: int) -> int:
    high, high_draw = 0, 0
    for i in range(bucket.size):
        draw = (hashing.hash3(x, bucket.items[i] & 0xFFFFFFFF, r) & 0xFFFF) \
            * bucket.straws[i]
        if i == 0 or draw > high_draw:
            high, high_draw = i, draw
    return bucket.items[high]


def bucket_straw2_choose(bucket: Bucket, x: int, r: int,
                         arg: Optional[ChooseArg], position: int) -> int:
    weights = bucket.weights
    ids = bucket.items
    if arg is not None and arg.weight_set is not None:
        pos = min(position, len(arg.weight_set) - 1)
        weights = arg.weight_set[pos]
    if arg is not None and arg.ids is not None:
        ids = arg.ids
    high, high_draw = 0, 0
    for i in range(bucket.size):
        if weights[i]:
            u = hashing.hash3(x, ids[i] & 0xFFFFFFFF, r) & 0xFFFF
            draw = lntable.straw2_draw(u, weights[i])
        else:
            draw = S64_MIN
        if i == 0 or draw > high_draw:
            high, high_draw = i, draw
    return bucket.items[high]


def bucket_choose(bucket: Bucket, work: _PermState, x: int, r: int,
                  arg: Optional[ChooseArg], position: int) -> int:
    if bucket.alg == BUCKET_UNIFORM:
        return bucket_perm_choose(bucket, work, x, r)
    if bucket.alg == BUCKET_LIST:
        return bucket_list_choose(bucket, x, r)
    if bucket.alg == BUCKET_TREE:
        return bucket_tree_choose(bucket, x, r)
    if bucket.alg == BUCKET_STRAW:
        return bucket_straw_choose(bucket, x, r)
    if bucket.alg == BUCKET_STRAW2:
        return bucket_straw2_choose(bucket, x, r, arg, position)
    return bucket.items[0]


def is_out(cmap: CrushMap, weight: Sequence[int], item: int, x: int) -> bool:
    """Device overload rejection (mapper.c:424-438)."""
    if item >= len(weight):
        return True
    w = weight[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (hashing.hash2(x, item) & 0xFFFF) >= w


# ------------------------------------------------------------- choosers -----

def _choose_arg_for(choose_args, bucket_id: int) -> Optional[ChooseArg]:
    if choose_args is None:
        return None
    idx = -1 - bucket_id
    if idx >= len(choose_args):
        return None
    return choose_args[idx]


def choose_firstn(cmap: CrushMap, work: Workspace, bucket: Bucket,
                  weight: Sequence[int], x: int, numrep: int, type_: int,
                  out: List[int], outpos: int, out_size: int,
                  tries: int, recurse_tries: int, local_retries: int,
                  local_fallback_retries: int, recurse_to_leaf: bool,
                  vary_r: int, stable: int, out2: Optional[List[int]],
                  parent_r: int, choose_args) -> int:
    """Depth-first draw-with-retry (mapper.c:460-648)."""
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        retry_descent = True
        item = 0
        while retry_descent:
            retry_descent = False
            in_bucket = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                collide = False
                r = rep + parent_r + ftotal
                if in_bucket.size == 0:
                    reject = True
                else:
                    if (local_fallback_retries > 0 and
                            flocal >= (in_bucket.size >> 1) and
                            flocal > local_fallback_retries):
                        item = bucket_perm_choose(
                            in_bucket, work.perm(in_bucket.id), x, r)
                    else:
                        item = bucket_choose(
                            in_bucket, work.perm(in_bucket.id), x, r,
                            _choose_arg_for(choose_args, in_bucket.id), outpos)
                    if item >= cmap.max_devices:
                        skip_rep = True
                        break
                    itemtype = cmap.bucket(item).type if item < 0 else 0
                    if itemtype != type_:
                        if item >= 0 or (-1 - item) >= cmap.max_buckets:
                            skip_rep = True
                            break
                        in_bucket = cmap.bucket(item)
                        retry_bucket = True
                        continue
                    for i in range(outpos):
                        if out[i] == item:
                            collide = True
                            break
                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = (r >> (vary_r - 1)) if vary_r else 0
                            got = choose_firstn(
                                cmap, work, cmap.bucket(item), weight, x,
                                1 if stable else outpos + 1, 0,
                                out2, outpos, count,
                                recurse_tries, 0, local_retries,
                                local_fallback_retries, False,
                                vary_r, stable, None, sub_r, choose_args)
                            if got <= outpos:
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject and not collide:
                        if itemtype == 0:
                            reject = is_out(cmap, weight, item, x)
                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (local_fallback_retries > 0 and
                          flocal <= in_bucket.size + local_fallback_retries):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True
            if skip_rep:
                break
        if not skip_rep:
            out[outpos] = item
            outpos += 1
            count -= 1
        rep += 1
    return outpos


def choose_indep(cmap: CrushMap, work: Workspace, bucket: Bucket,
                 weight: Sequence[int], x: int, left: int, numrep: int,
                 type_: int, out: List[int], outpos: int,
                 tries: int, recurse_tries: int, recurse_to_leaf: bool,
                 out2: Optional[List[int]], parent_r: int, choose_args) -> None:
    """Breadth-first positionally-stable selection (mapper.c:655-843)."""
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = ITEM_UNDEF
        if out2 is not None:
            out2[rep] = ITEM_UNDEF
    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != ITEM_UNDEF:
                continue
            in_bucket = bucket
            while True:
                r = rep + parent_r
                if (in_bucket.alg == BUCKET_UNIFORM and
                        in_bucket.size % numrep == 0):
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_bucket.size == 0:
                    break
                item = bucket_choose(
                    in_bucket, work.perm(in_bucket.id), x, r,
                    _choose_arg_for(choose_args, in_bucket.id), outpos)
                if item >= cmap.max_devices:
                    out[rep] = ITEM_NONE
                    if out2 is not None:
                        out2[rep] = ITEM_NONE
                    left -= 1
                    break
                itemtype = cmap.bucket(item).type if item < 0 else 0
                if itemtype != type_:
                    if item >= 0 or (-1 - item) >= cmap.max_buckets:
                        out[rep] = ITEM_NONE
                        if out2 is not None:
                            out2[rep] = ITEM_NONE
                        left -= 1
                        break
                    in_bucket = cmap.bucket(item)
                    continue
                collide = False
                for i in range(outpos, endpos):
                    if out[i] == item:
                        collide = True
                        break
                if collide:
                    break
                if recurse_to_leaf:
                    if item < 0:
                        choose_indep(cmap, work, cmap.bucket(item), weight, x,
                                     1, numrep, 0, out2, rep,
                                     recurse_tries, 0, False, None, r,
                                     choose_args)
                        if out2 is not None and out2[rep] == ITEM_NONE:
                            break
                    elif out2 is not None:
                        out2[rep] = item
                if itemtype == 0 and is_out(cmap, weight, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] == ITEM_UNDEF:
            out[rep] = ITEM_NONE
        if out2 is not None and out2[rep] == ITEM_UNDEF:
            out2[rep] = ITEM_NONE


# -------------------------------------------------------------- do_rule -----

def do_rule(cmap: CrushMap, ruleno: int, x: int, result_max: int,
            weight: Sequence[int],
            choose_args=None) -> List[int]:
    """Run one rule program (mapper.c:900-1105). Returns the result vector."""
    if ruleno < 0 or ruleno >= cmap.max_rules or cmap.rules[ruleno] is None:
        return []
    rule = cmap.rules[ruleno]
    work = Workspace(cmap)

    result: List[int] = []
    # +1 so result_max == 0 degenerates gracefully (the C caller's scratch
    # buffer always has room for the TAKE slot; choose steps then no-op)
    w: List[int] = [0] * (result_max + 1)
    o: List[int] = [0] * (result_max + 1)
    c: List[int] = [0] * (result_max + 1)
    wsize = 0

    choose_tries = cmap.tunables.choose_total_tries + 1
    choose_leaf_tries = 0
    choose_local_retries = cmap.tunables.choose_local_tries
    choose_local_fallback_retries = cmap.tunables.choose_local_fallback_tries
    vary_r = cmap.tunables.chooseleaf_vary_r
    stable = cmap.tunables.chooseleaf_stable

    for op, arg1, arg2 in rule.steps:
        firstn = False
        if op == RULE_TAKE:
            if (0 <= arg1 < cmap.max_devices) or \
               (0 <= -1 - arg1 < cmap.max_buckets and cmap.bucket(arg1)):
                w[0] = arg1
                wsize = 1
        elif op == RULE_SET_CHOOSE_TRIES:
            if arg1 > 0:
                choose_tries = arg1
        elif op == RULE_SET_CHOOSELEAF_TRIES:
            if arg1 > 0:
                choose_leaf_tries = arg1
        elif op == RULE_SET_CHOOSE_LOCAL_TRIES:
            if arg1 >= 0:
                choose_local_retries = arg1
        elif op == RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if arg1 >= 0:
                choose_local_fallback_retries = arg1
        elif op == RULE_SET_CHOOSELEAF_VARY_R:
            if arg1 >= 0:
                vary_r = arg1
        elif op == RULE_SET_CHOOSELEAF_STABLE:
            if arg1 >= 0:
                stable = arg1
        elif op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSE_FIRSTN,
                    RULE_CHOOSELEAF_INDEP, RULE_CHOOSE_INDEP):
            if wsize == 0:
                continue
            firstn = op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSE_FIRSTN)
            recurse_to_leaf = op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP)
            osize = 0
            for i in range(wsize):
                numrep = arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                bno = -1 - w[i]
                if bno < 0 or bno >= cmap.max_buckets or cmap.buckets[bno] is None:
                    continue
                bucket = cmap.buckets[bno]
                # the reference passes o+osize / c+osize with outpos=0, so
                # r-values and collision scans are relative to this take's
                # own output window (mapper.c:1036-1074)
                o_sub = o[osize:]
                c_sub = c[osize:]
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif cmap.tunables.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    placed = choose_firstn(
                        cmap, work, bucket, weight, x, numrep, arg2,
                        o_sub, 0, result_max - osize,
                        choose_tries, recurse_tries,
                        choose_local_retries, choose_local_fallback_retries,
                        recurse_to_leaf, vary_r, stable,
                        c_sub, 0, choose_args)
                    o[osize:osize + len(o_sub)] = o_sub
                    c[osize:osize + len(c_sub)] = c_sub
                    osize += placed
                else:
                    out_size = min(numrep, result_max - osize)
                    choose_indep(
                        cmap, work, bucket, weight, x, out_size, numrep,
                        arg2, o_sub, 0,
                        choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, c_sub, 0, choose_args)
                    o[osize:osize + len(o_sub)] = o_sub
                    c[osize:osize + len(c_sub)] = c_sub
                    osize += out_size
            if recurse_to_leaf:
                for i in range(osize):
                    o[i] = c[i]
            w, o = o, w
            wsize = osize
        elif op == RULE_EMIT:
            for i in range(wsize):
                if len(result) >= result_max:
                    break
                result.append(w[i])
            wsize = 0
    return result
