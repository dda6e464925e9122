"""`rbd` — block-image CLI over librbd.

The reference's rbd tool (src/tools/rbd/): image lifecycle, snapshot
family, clone layering.  Drives the librbd slice (client/rbd.py) over
an injected ioctx, like radosgw-admin (the reference links librbd
directly too).

    main(["create", "img", "--size", "8388608"], ioctx=io, out=buf)
    main(["ls"], ...)                 main(["info", "img"], ...)
    main(["snap", "create", "img@s1"], ...)
    main(["snap", "ls", "img"], ...)  main(["snap", "rollback", "img@s1"], ...)
    main(["snap", "protect", "img@s1"], ...)
    main(["clone", "img@s1", "child"], ...)
    main(["flatten", "child"], ...)   main(["children", "img@s1"], ...)
    main(["resize", "img", "--size", N], ...)   main(["rm", "img"], ...)
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _split_at(spec: str):
    if "@" not in spec:
        raise SystemExit(f"rbd: expected image@snap, got {spec!r}")
    return spec.split("@", 1)


def main(argv: Optional[List[str]] = None, ioctx=None, out=None) -> int:
    out = out or sys.stdout
    if ioctx is None:
        raise SystemExit("rbd: an ioctx must be provided")
    ap = argparse.ArgumentParser(prog="rbd")
    ap.add_argument("words", nargs="+")
    ap.add_argument("--size", type=int)
    ap.add_argument("--order", type=int, default=22)
    ns = ap.parse_args(argv)
    w = ns.words
    _MIN = {"create": 2, "info": 2, "rm": 2, "resize": 2, "snap": 3,
            "clone": 3, "flatten": 2, "children": 2}
    if len(w) < _MIN.get(w[0], 1):
        ap.error(f"{' '.join(w)}: missing operand(s)")

    from ..client.rbd import RBD, Image, ImageExists, ImageNotFound
    rbd = RBD(ioctx)

    def emit(obj) -> int:
        out.write(json.dumps(obj, indent=2, sort_keys=True) + "\n")
        return 0

    try:
        if w[0] == "create":
            if ns.size is None:
                ap.error("create requires --size")
            rbd.create(w[1], ns.size, order=ns.order)
            return emit({"created": w[1], "size": ns.size})
        if w[0] == "ls":
            return emit(rbd.list())
        if w[0] == "info":
            img = Image(ioctx, w[1])
            return emit({"name": w[1], "size": img.size(),
                         "order": img.info.order,
                         "snaps": img.snap_list(),
                         "parent": img.parent})
        if w[0] == "rm":
            rbd.remove(w[1])
            return emit({"removed": w[1]})
        if w[0] == "resize":
            if ns.size is None:
                ap.error("resize requires --size")
            Image(ioctx, w[1]).resize(ns.size)
            return emit({"resized": w[1], "size": ns.size})
        if w[0] == "snap":
            if w[1] == "ls":
                return emit(Image(ioctx, w[2]).snap_list())
            name, snap = _split_at(w[2])
            img = Image(ioctx, name)
            if w[1] == "create":
                img.snap_create(snap)
            elif w[1] == "rollback":
                img.snap_rollback(snap)
            elif w[1] == "rm":
                img.snap_remove(snap)
            elif w[1] == "protect":
                img.protect_snap(snap)
            elif w[1] == "unprotect":
                img.unprotect_snap(snap)
            else:
                ap.error(f"unknown snap command {w[1]!r}")
            return emit({"snap": f"{name}@{snap}", "op": w[1]})
        if w[0] == "clone":
            parent, snap = _split_at(w[1])
            rbd.clone(parent, snap, w[2])
            return emit({"cloned": w[2], "parent": w[1]})
        if w[0] == "flatten":
            Image(ioctx, w[1]).flatten()
            return emit({"flattened": w[1]})
        if w[0] == "children":
            parent, snap = _split_at(w[1])
            img = Image(ioctx, parent)
            if snap not in img.snaps:
                raise KeyError(f"{parent} has no snap {snap!r}")
            # only the NAMED snap's clones (reference `rbd children`)
            return emit(sorted(
                img.snaps[snap].get("children", [])))
        ap.error(f"unknown command: {' '.join(w)}")
        return 2
    except (ImageExists, ImageNotFound, ValueError, KeyError) as e:
        out.write(f"{type(e).__name__}: {e}\n")
        return 1


if __name__ == "__main__":
    main()
