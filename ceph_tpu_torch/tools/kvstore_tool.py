"""`ceph-kvstore-tool` — offline KV store surgery.

The reference tool (src/tools/kvstore_tool.cc behind
`ceph-kvstore-tool`): list/get/set/rm keys on a KeyValueDB and
compact it.  Here it operates on WalDB directories — the store under
the mon (MonitorDBStore), BlueStore metadata and FileStore metadata
all use the same engine, so one tool inspects them all.

    python -m ceph_tpu_torch.tools.kvstore_tool <db-path> list [prefix]
    python -m ceph_tpu_torch.tools.kvstore_tool <db-path> get <prefix> <key>
    python -m ceph_tpu_torch.tools.kvstore_tool <db-path> set <prefix> <key> <file|->
    python -m ceph_tpu_torch.tools.kvstore_tool <db-path> rm <prefix> <key>
    python -m ceph_tpu_torch.tools.kvstore_tool <db-path> compact
    python -m ceph_tpu_torch.tools.kvstore_tool <db-path> stats
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None, out=None,
         data_in: Optional[bytes] = None) -> int:
    out = out or sys.stdout
    ap = argparse.ArgumentParser(prog="ceph-kvstore-tool")
    ap.add_argument("path")
    ap.add_argument("words", nargs="+")
    ns = ap.parse_args(argv)
    from ..cluster.kv import WriteBatch
    from ..cluster.wal_kv import WalDB
    db = WalDB(ns.path, fsync=True)
    try:
        w = ns.words
        if w[0] == "list":
            prefixes = ([w[1]] if len(w) > 1 else
                        sorted({p for p, _ in db._keys}))
            for p in prefixes:
                for k, v in db.iterate(p):
                    out.write(f"{p}\t{k}\t({len(v)} bytes)\n")
            return 0
        if w[0] == "get":
            if len(w) < 3:
                ap.error("get needs <prefix> <key>")
            v = db.get(w[1], w[2])
            if v is None:
                out.write("(no such key)\n")
                return 1
            if hasattr(out, "buffer"):
                out.buffer.write(v)
            else:
                out.write(v.decode("latin-1"))
            return 0
        if w[0] == "set":
            if len(w) < 4:
                ap.error("set needs <prefix> <key> <file|->")
            data = data_in if w[3] == "-" and data_in is not None \
                else (sys.stdin.buffer.read() if w[3] == "-"
                      else open(w[3], "rb").read())
            db.submit(WriteBatch().set(w[1], w[2], data))
            out.write(f"set {w[1]}/{w[2]} ({len(data)} bytes)\n")
            return 0
        if w[0] == "rm":
            if len(w) < 3:
                ap.error("rm needs <prefix> <key>")
            if db.get(w[1], w[2]) is None:
                out.write("(no such key)\n")
                return 1
            db.submit(WriteBatch().rm(w[1], w[2]))
            out.write(f"removed {w[1]}/{w[2]}\n")
            return 0
        if w[0] == "compact":
            db.compact()
            out.write("compacted\n")
            return 0
        if w[0] == "stats":
            prefixes: dict = {}
            total = 0
            for p, k in db._keys:
                v = db._data[(p, k)]
                s = prefixes.setdefault(p, {"keys": 0, "bytes": 0})
                s["keys"] += 1
                s["bytes"] += len(v)
                total += len(v)
            for p in sorted(prefixes):
                s = prefixes[p]
                out.write(f"{p}\t{s['keys']} keys\t{s['bytes']} bytes\n")
            out.write(f"TOTAL\t{sum(s['keys'] for s in prefixes.values())}"
                      f" keys\t{total} bytes\n")
            return 0
        ap.error(f"unknown command {w[0]!r}")
        return 2
    finally:
        db.close()


if __name__ == "__main__":
    sys.exit(main())
