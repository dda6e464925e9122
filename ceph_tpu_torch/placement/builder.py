"""Map-construction helpers (the builder.c role).

One canonical straw2 hierarchy builder shared by benchmarks, the
multi-device dry run, and tests — root → [racks →] hosts → osds — plus the mutation
surface builder.c exposes: remove_item, reweight_item,
reweight_subtree, move_bucket (crush_remove_item / crush_reweight_* /
CrushWrapper::move_bucket roles), all with ancestor weight
propagation and derived-table refresh.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .crush_map import (BUCKET_STRAW2, BUCKET_UNIFORM, Bucket, CrushMap,
                        Tunables, WEIGHT_ONE)

TYPE_OSD, TYPE_HOST, TYPE_RACK, TYPE_ROOT = 0, 1, 2, 3


def build_flat_cluster(n_hosts: int = 6, osds_per_host: int = 4,
                       n_racks: int = 0, seed: int = 0,
                       tunables: Optional[Tunables] = None,
                       weight_jitter: bool = False
                       ) -> Tuple[CrushMap, int]:
    """Build root → [racks →] hosts → osds, all straw2.

    Returns (map, root_bucket_id).  With weight_jitter, per-osd weights
    are randomized in [0.5, 1.5) to exercise weighted selection.
    """
    rng = np.random.default_rng(seed)
    m = CrushMap(tunables=tunables or Tunables.profile("jewel"))
    m.type_names = {TYPE_OSD: "osd", TYPE_HOST: "host", TYPE_RACK: "rack",
                    TYPE_ROOT: "root"}
    osd = 0
    host_ids = []
    for h in range(n_hosts):
        items, weights = [], []
        for _ in range(osds_per_host):
            items.append(osd)
            w = WEIGHT_ONE
            if weight_jitter:
                w = int(WEIGHT_ONE * (0.5 + rng.random()))
            weights.append(w)
            osd += 1
        hid = -1 - len(m.buckets)
        m.add_bucket(Bucket(id=hid, alg=BUCKET_STRAW2, type=TYPE_HOST,
                            items=items, weights=weights))
        m.bucket_names[hid] = f"host{h}"
        host_ids.append(hid)
    group_ids = host_ids
    if n_racks:
        racks = []
        per = max(1, len(host_ids) // n_racks)
        for r in range(n_racks):
            hs = host_ids[r * per:(r + 1) * per] or host_ids[-1:]
            rid = -1 - len(m.buckets)
            m.add_bucket(Bucket(
                id=rid, alg=BUCKET_STRAW2, type=TYPE_RACK, items=list(hs),
                weights=[sum(m.bucket(h).weights) for h in hs]))
            m.bucket_names[rid] = f"rack{r}"
            racks.append(rid)
        group_ids = racks
    root_id = -1 - len(m.buckets)
    m.add_bucket(Bucket(
        id=root_id, alg=BUCKET_STRAW2, type=TYPE_ROOT, items=list(group_ids),
        weights=[sum(m.bucket(g).weights) for g in group_ids]))
    m.bucket_names[root_id] = "default"
    m.finalize()
    return m, root_id


# ------------------------------------------------------- map mutations ----

def find_parent(cmap: CrushMap, item_id: int) -> Optional[int]:
    """Bucket id containing ``item_id`` (items appear at most once in a
    well-formed map)."""
    for b in cmap.buckets:
        if b is not None and item_id in b.items:
            return b.id
    return None


def _ancestors(cmap: CrushMap, bucket_id: int) -> List[int]:
    out = []
    cur = find_parent(cmap, bucket_id)
    while cur is not None:
        out.append(cur)
        cur = find_parent(cmap, cur)
    return out


def _adjust_ancestor_weights(cmap: CrushMap, child_id: int,
                             delta: int) -> None:
    """Propagate a weight change up the chain (builder.c
    crush_reweight_bucket's role)."""
    cur = child_id
    parent = find_parent(cmap, cur)
    while parent is not None:
        pb = cmap.bucket(parent)
        if pb.alg == BUCKET_UNIFORM:
            break                # uniform interiors don't track items
        pos = pb.items.index(cur)
        pb.weights[pos] = max(0, pb.weights[pos] + delta)
        cur = parent
        parent = find_parent(cmap, cur)


def remove_item(cmap: CrushMap, item_id: int) -> None:
    """Detach a device or (empty) bucket from its parent, propagating
    the weight loss upward (crush_remove_item role); removing a bucket
    also frees its slot."""
    if item_id < 0:
        b = cmap.bucket(item_id)
        if b is None:
            raise KeyError(f"no bucket {item_id}")
        if b.items:
            raise ValueError(
                f"bucket {item_id} not empty: remove its items first")
    parent = find_parent(cmap, item_id)
    if parent is not None:
        pb = cmap.bucket(parent)
        pos = pb.items.index(item_id)
        w = pb.item_weight(pos)
        del pb.items[pos]
        if pb.alg != BUCKET_UNIFORM:
            del pb.weights[pos]
        _adjust_ancestor_weights(cmap, parent, -w)
    if item_id < 0:
        cmap.buckets[-1 - item_id] = None
        cmap.bucket_names.pop(item_id, None)
    cmap.finalize()


def reweight_item(cmap: CrushMap, item_id: int, new_weight: int) -> None:
    """Set one item's weight in its parent and propagate the delta
    (crush_reweight role)."""
    parent = find_parent(cmap, item_id)
    if parent is None:
        raise KeyError(f"item {item_id} not in any bucket")
    pb = cmap.bucket(parent)
    if pb.alg == BUCKET_UNIFORM:
        raise ValueError("cannot reweight one item of a uniform bucket")
    pos = pb.items.index(item_id)
    delta = new_weight - pb.weights[pos]
    pb.weights[pos] = new_weight
    _adjust_ancestor_weights(cmap, parent, delta)
    cmap.finalize()


def reweight_subtree(cmap: CrushMap, bucket_id: int,
                     leaf_weight: int) -> None:
    """Set EVERY device weight under the subtree and rebuild interior
    weights bottom-up (CrushWrapper::adjust_subtree_weight role)."""
    b = cmap.bucket(bucket_id)
    if b is None:
        raise KeyError(f"no bucket {bucket_id}")

    def rebuild(bid: int) -> int:
        bk = cmap.bucket(bid)
        total = 0
        for pos, child in enumerate(bk.items):
            w = rebuild(child) if child < 0 else leaf_weight
            if bk.alg != BUCKET_UNIFORM:
                bk.weights[pos] = w
            total += w
        if bk.alg == BUCKET_UNIFORM:
            bk.weights = [leaf_weight]
            total = leaf_weight * bk.size
        return total

    old = b.weight
    new = rebuild(bucket_id)
    _adjust_ancestor_weights(cmap, bucket_id, new - old)
    cmap.finalize()


def move_bucket(cmap: CrushMap, bucket_id: int,
                new_parent_id: int) -> None:
    """Detach a subtree and reattach it under another bucket with its
    weight (CrushWrapper::move_bucket role); cycles rejected."""
    b = cmap.bucket(bucket_id)
    np_b = cmap.bucket(new_parent_id)
    if b is None or np_b is None:
        raise KeyError("bucket and new parent must exist")
    if new_parent_id == bucket_id or \
            bucket_id in _ancestors(cmap, new_parent_id):
        raise ValueError("move would create a cycle")
    if np_b.alg == BUCKET_UNIFORM:
        raise ValueError("cannot move into a uniform bucket")
    w = b.weight
    parent = find_parent(cmap, bucket_id)
    if parent is not None:
        pb = cmap.bucket(parent)
        pos = pb.items.index(bucket_id)
        del pb.items[pos]
        if pb.alg != BUCKET_UNIFORM:
            del pb.weights[pos]
        _adjust_ancestor_weights(cmap, parent, -w)
    np_b.items.append(bucket_id)
    np_b.weights.append(w)
    _adjust_ancestor_weights(cmap, new_parent_id, w)
    cmap.finalize()
