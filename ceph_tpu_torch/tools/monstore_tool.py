"""`ceph-monstore-tool` — offline mon store inspection/surgery.

The reference tool (src/tools/ceph_monstore_tool.cc): dump the
MonitorDBStore's committed state — map epochs, paxos versions, config
keys — and extract map blobs for disaster recovery.  Operates on a
stopped mon's WalDB directory (vstart lays them out as
<cluster>/mon-store[.<rank>]).

    python -m ceph_tpu_torch.tools.monstore_tool <store-path> summary
    python -m ceph_tpu_torch.tools.monstore_tool <store-path> dump-keys
    python -m ceph_tpu_torch.tools.monstore_tool <store-path> get-osdmap [epoch]
    python -m ceph_tpu_torch.tools.monstore_tool <store-path> dump-paxos
    python -m ceph_tpu_torch.tools.monstore_tool <store-path> dump-config
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None, out=None) -> int:
    out = out or sys.stdout
    ap = argparse.ArgumentParser(prog="ceph-monstore-tool")
    ap.add_argument("path")
    ap.add_argument("words", nargs="+")
    ns = ap.parse_args(argv)
    from ..cluster.wal_kv import WalDB
    db = WalDB(ns.path, fsync=False)
    try:
        w = ns.words
        if w[0] == "summary":
            epochs = [k for k, _ in db.iterate("osdmap")]
            paxos = [k for k, _ in db.iterate("paxos")]
            cfg = [k for k, _ in db.iterate("config")]
            out.write(f"osdmap epochs: {len(epochs)}"
                      + (f" (first {int(epochs[0])}, last "
                         f"{int(epochs[-1])})" if epochs else "")
                      + "\n")
            out.write(f"paxos versions: {len(paxos)}"
                      + (f" (last {int(paxos[-1])})" if paxos else "")
                      + "\n")
            out.write(f"config keys: {len(cfg)}\n")
            return 0
        if w[0] == "dump-keys":
            for p in sorted({p for p, _ in db._keys}):
                for k, v in db.iterate(p):
                    out.write(f"{p}\t{k}\t({len(v)} bytes)\n")
            return 0
        if w[0] == "get-osdmap":
            epochs = [k for k, _ in db.iterate("osdmap")]
            if not epochs:
                out.write("(no committed osdmap incrementals)\n")
                return 1
            key = f"{int(w[1]):010d}" if len(w) > 1 else epochs[-1]
            blob = db.get("osdmap", key)
            if blob is None:
                out.write(f"(no osdmap epoch {int(key)})\n")
                return 1
            if hasattr(out, "buffer"):
                out.buffer.write(blob)
            else:
                out.write(blob.decode("latin-1"))
            return 0
        if w[0] == "dump-paxos":
            for k, v in db.iterate("paxos"):
                out.write(f"{int(k)}\t{v.decode(errors='replace')}\n")
            return 0
        if w[0] == "dump-config":
            for k, v in db.iterate("config"):
                out.write(f"{k} = {v.decode(errors='replace')}\n")
            return 0
        ap.error(f"unknown command {w[0]!r}")
        return 2
    finally:
        db.close()


if __name__ == "__main__":
    sys.exit(main())
