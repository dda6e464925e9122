"""objectstore-tool — offline FileStore surgery (ceph-objectstore-tool).

The reference tool (src/tools/ceph_objectstore_tool.cc) mounts a
stopped OSD's store for offline inspection and repair: list PGs and
objects, export/import objects, fsck, remove.  Same surface over the
durable FileStore:

    python -m ceph_tpu_torch.tools.objectstore_tool --store DIR <op> [...]

    ops: list-pgs
         list [--pg POOL.PG]
         info  --pg POOL.PG --oid OID
         export --pg POOL.PG --oid OID --file OUT
         import --pg POOL.PG --oid OID --file IN
         remove --pg POOL.PG --oid OID
         fsck
         gc

Export files are JSON envelopes (data base64 + xattrs + omap), so an
object can move between stores byte-faithfully — the export/import
PG-surgery role.
"""
from __future__ import annotations

import argparse
import base64
import json
import sys
from typing import Tuple


def _pg(s: str) -> Tuple[int, int]:
    pool, pg = s.split(".")
    return int(pool), int(pg)


def _open(store_dir: str, fsck_on_mount: bool = False):
    from ..cluster.filestore import FileStore
    return FileStore(store_dir, fsync=False,
                     fsck_on_mount=fsck_on_mount)


def _obj_rows(fs, coll, oid):
    """xattr + omap rows for an object via the kv iterators (key schema
    comes from the store itself, never re-derived here)."""
    from ..cluster.filestore import _objkey
    out = {"xattrs": {}, "omap": {}}
    prefix_key = _objkey(coll, oid) + "\x00"
    for kind, dest in (("xattr", "xattrs"), ("omap", "omap")):
        for k, v in fs.kv.iterate(kind, start=prefix_key):
            if not k.startswith(prefix_key):
                break
            out[dest][k[len(prefix_key):]] = base64.b64encode(v).decode()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="objectstore-tool")
    ap.add_argument("--store", required=True)
    ap.add_argument("op", choices=["list-pgs", "list", "info", "export",
                                   "import", "remove", "fsck", "gc"])
    ap.add_argument("--pg")
    ap.add_argument("--oid")
    ap.add_argument("--file")
    args = ap.parse_args(argv)
    _REQUIRED = {"info": ("pg", "oid"), "export": ("pg", "oid", "file"),
                 "import": ("file",), "remove": ("pg", "oid")}
    for need in _REQUIRED.get(args.op, ()):
        if getattr(args, need) is None:
            ap.error(f"{args.op} requires --{need}")
    fs = _open(args.store)
    try:
        if args.op == "list-pgs":
            for coll in fs.list_collections():
                print(f"{coll[0]}.{coll[1]}")
        elif args.op == "list":
            colls = [_pg(args.pg)] if args.pg else fs.list_collections()
            for coll in colls:
                for oid in fs.list_objects(coll):
                    print(f"{coll[0]}.{coll[1]}\t{oid}")
        elif args.op == "info":
            coll = _pg(args.pg)
            st = fs.stat(coll, args.oid)
            rows = _obj_rows(fs, coll, args.oid)
            print(json.dumps({"pg": args.pg, "oid": args.oid,
                              "size": st["size"],
                              "crc32": st["csum"],
                              "n_xattrs": len(rows["xattrs"]),
                              "n_omap": len(rows["omap"])}))
        elif args.op == "export":
            coll = _pg(args.pg)
            data = fs.read(coll, args.oid)
            env = {"pg": args.pg, "oid": args.oid,
                   "data": base64.b64encode(data).decode()}
            env.update(_obj_rows(fs, coll, args.oid))
            with open(args.file, "w") as f:
                json.dump(env, f)
            print(f"exported {args.oid} ({len(data)} bytes)")
        elif args.op == "import":
            from ..cluster.objectstore import Transaction
            with open(args.file) as f:
                env = json.load(f)
            # --pg/--oid override the export envelope's placement
            coll = _pg(args.pg or env["pg"])
            oid = args.oid or env["oid"]
            txn = Transaction()
            txn.write_full(coll, oid, base64.b64decode(env["data"]))
            for k, v in env.get("xattrs", {}).items():
                txn.setattr(coll, oid, k, base64.b64decode(v))
            for k, v in env.get("omap", {}).items():
                txn.omap_set(coll, oid, k, base64.b64decode(v))
            fs.apply_transaction(txn)
            print(f"imported {oid}")
        elif args.op == "remove":
            from ..cluster.objectstore import Transaction
            fs.apply_transaction(
                Transaction().remove(_pg(args.pg), args.oid))
            print(f"removed {args.oid}")
        elif args.op == "fsck":
            bad = fs.fsck()
            print(json.dumps({
                "bad_objects": [[list(c), o] for c, o in bad],
                "orphan_bytes": fs.last_fsck_orphan_bytes}))
            return 1 if bad else 0
        elif args.op == "gc":
            print(f"reclaimed {fs.gc_data_log()} bytes")
    finally:
        fs.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
