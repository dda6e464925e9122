"""`rados` — the object CLI against a live process cluster.

The reference's rados tool (src/tools/rados/rados.cc: put/get/ls/rm/
stat/bench basics) over the authenticated wire client, whose codec and
checksums run on the card unless ``--device cpu`` asks for the CPU.

    python -m ceph_tpu_torch.tools.rados_cli --dir /tmp/c1 -p rep put obj ./file
    python -m ceph_tpu_torch.tools.rados_cli --dir /tmp/c1 -p rep get obj -
    python -m ceph_tpu_torch.tools.rados_cli --dir /tmp/c1 -p rep ls
    python -m ceph_tpu_torch.tools.rados_cli --dir /tmp/c1 -p rep rm obj
    python -m ceph_tpu_torch.tools.rados_cli --dir /tmp/c1 -p rep bench 8
    python -m ceph_tpu_torch.tools.rados_cli --device cpu --dir /tmp/c1 ...
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

from .. import using_device


def _pool_id(rc, name: str) -> int:
    for pid, pool in rc.osdmap.pools.items():
        if pool.name == name or str(pid) == name:
            return pid
    raise SystemExit(f"rados: no pool {name!r}")


def main(argv: Optional[List[str]] = None, out=None,
         data_in: Optional[bytes] = None) -> int:
    out = out or sys.stdout
    ap = argparse.ArgumentParser(prog="rados")
    ap.add_argument("--dir", required=True)
    ap.add_argument("-p", "--pool", required=True)
    ap.add_argument("words", nargs="+")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the client (cuda or cpu)")
    ns = ap.parse_args(argv)
    # the client runs on the package default device: this run's
    with using_device(ns.device):
        return _run(ap, ns, out, data_in)


def _run(ap, ns, out, data_in: Optional[bytes]) -> int:
    from ..client.remote import RemoteCluster
    rc = RemoteCluster(ns.dir)
    try:
        pid = _pool_id(rc, ns.pool)
        w = ns.words
        _ARITY = {"ls": 1, "put": 3, "get": 3, "rm": 2, "bench": 1}
        if w[0] in _ARITY and len(w) < _ARITY[w[0]]:
            ap.error(f"rados {w[0]}: missing operand(s)")
        if w[0] == "ls":
            for n in rc.list_objects(pid):
                out.write(n + "\n")
            return 0
        if w[0] == "put":
            name, src = w[1], w[2]
            data = data_in if src == "-" and data_in is not None \
                else (sys.stdin.buffer.read() if src == "-"
                      else open(src, "rb").read())
            acks = rc.put(pid, name, data)
            out.write(f"wrote {len(data)} bytes ({acks} acks)\n")
            return 0
        if w[0] == "get":
            name, dst = w[1], w[2]
            data = rc.get(pid, name)
            if dst == "-":
                if hasattr(out, "buffer"):
                    out.buffer.write(data)
                else:
                    out.write(data.decode("latin-1"))
            else:
                open(dst, "wb").write(data)
            return 0
        if w[0] == "rm":
            acks = rc.delete(pid, w[1])
            out.write(f"removed {w[1]} ({acks} acks)\n")
            return 0 if acks else 1
        if w[0] == "bench":
            seconds = float(w[1]) if len(w) > 1 else 5.0
            payload = b"\xab" * (1 << 20)
            t0 = time.monotonic()
            n = 0
            while time.monotonic() - t0 < seconds:
                rc.put(pid, f"bench_{n}", payload)
                n += 1
            dt = time.monotonic() - t0
            out.write(f"{n} writes x 1 MiB in {dt:.2f}s = "
                      f"{n / dt:.1f} MiB/s\n")
            return 0
        ap.error(f"unknown command {w[0]!r}")
        return 2
    finally:
        rc.close()


if __name__ == "__main__":
    sys.exit(main())
