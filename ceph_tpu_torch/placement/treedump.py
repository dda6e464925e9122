"""CrushLocation + tree dumper.

Roles of src/crush/CrushLocation.{h,cc} (where does this host/device
sit in the hierarchy — the crush position a daemon announces on boot)
and src/crush/CrushTreeDumper.h (the `ceph osd tree` renderer walking
buckets depth-first with per-node type/name/weight).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .crush_map import CrushMap


def crush_location(cmap: CrushMap, item: int) -> Dict[str, str]:
    """{type_name: bucket_name} ancestors of a device or bucket —
    the CrushLocation lookup (e.g. {'host': 'node1', 'root':
    'default'})."""
    parents: Dict[int, int] = {}
    for b in cmap.buckets:
        if b is None:
            continue
        for it in b.items:
            parents[it] = b.id
    out: Dict[str, str] = {}
    cur = item
    seen = set()
    while cur in parents and cur not in seen:
        seen.add(cur)
        cur = parents[cur]
        b = cmap.bucket(cur)
        if b is None:
            break
        tname = cmap.type_names.get(b.type, f"type{b.type}")
        out[tname] = cmap.bucket_names.get(cur, f"bucket{-1 - cur}")
    return out


def _fmt_weight(w: int) -> str:
    return f"{w / 0x10000:.5f}"


def tree_dump(cmap: CrushMap,
              device_weights: Optional[Dict[int, int]] = None
              ) -> str:
    """`ceph osd tree`-style text: depth-first from roots, one row per
    node with id, class, weight, type and name."""
    shadows = set(cmap.class_bucket_ids.values())
    children = set()
    for b in cmap.buckets:
        if b is None or b.id in shadows:
            continue
        for it in b.items:
            if it < 0:
                children.add(it)
    roots = [b.id for b in cmap.buckets
             if b is not None and b.id not in children
             and b.id not in shadows]
    lines = ["ID    CLASS  WEIGHT    TYPE NAME"]

    def emit(node: int, depth: int, weight: int) -> None:
        pad = "    " * depth
        if node >= 0:
            cls = cmap.device_classes.get(node, "")
            name = cmap.device_names.get(node, f"osd.{node}")
            lines.append(f"{node:>4}  {cls:<5}  {_fmt_weight(weight):>8}"
                         f"  {pad}{name}")
            return
        b = cmap.bucket(node)
        if b is None:
            return
        tname = cmap.type_names.get(b.type, f"type{b.type}")
        name = cmap.bucket_names.get(node, f"bucket{-1 - node}")
        lines.append(f"{node:>4}         {_fmt_weight(b.weight):>8}"
                     f"  {pad}{tname} {name}")
        for pos, it in enumerate(b.items):
            emit(it, depth + 1, b.item_weight(pos))

    for r in sorted(roots, reverse=True):
        b = cmap.bucket(r)
        emit(r, 0, b.weight if b else 0)
    return "\n".join(lines) + "\n"
