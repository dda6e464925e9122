"""ZeroWire smoke check of the port — one-pass integrity and the shm lane,
end to end against live daemons.

The twin of ``scripts/check_wire.py``.  Asserts the evidence the
zero-copy wire claims:

  * ONE crc pass per byte: with client csums precomputed (the
    reference's host ``Csums.scan``, standing in for csums staged with
    the bytes), a put's payload is scanned exactly once — the daemon's
    verify — and BlueStore adopts the verified sub-crcs
    (``trusted_csum_bytes`` advances, ``scan_store_bytes`` does NOT);
    counted by the perf('wire.zero') scan hook, not assumed;
  * the shm lane NEGOTIATES on a vstart pair and actually carries the
    payload bytes (client ``shm_bytes``/daemon ``shm_frames_served``
    advance), with readback byte-identical;
  * TCP/socket fallback: with ``wire_shm_ring_kib=0`` the same ops
    complete with no ring traffic — the lane is an optimization, not
    a dependency.

The daemons run on the CPU (``--device cpu``, as every daemon of the
port); the client runs on ``--device``, so on the card the puts of
legs 2 and 3 checksum their frames with K3's crc leg.  Only the
``wire.zero`` counters read around each leg count.

    python -m ceph_tpu_torch.tools.check_wire                # the card
    python -m ceph_tpu_torch.tools.check_wire --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def _daemon_counters(cluster_dir: str, n_osds: int) -> dict:
    from ..common import crcutil
    return crcutil.wire_zero_counters(cluster_dir, n_osds,
                                      include_local=False)


def run_checks(cluster_dir: str, n_osds: int) -> int:
    from ..client.remote import RemoteCluster
    from ..common import crcutil
    from ..common.options import config
    from ..common.perf_counters import perf

    rc = RemoteCluster(cluster_dir)
    pool = rc.osdmap.pools[1]

    # 1) exactly one crc pass per byte via the scan-counting hook
    data = os.urandom(4 << 20)
    cs = crcutil.Csums.scan(data)       # the device-crc stand-in
    pg = rc._pg_for(pool, "cw-onepass")
    tgt = [o for o in rc._up(pool, pg) if o >= 0][0]
    d0 = _daemon_counters(cluster_dir, n_osds)
    c0 = perf("wire.zero").dump()
    rc.osd_call(tgt, {"cmd": "put_shard", "coll": [1, pg],
                      "oid": "0:cw-onepass", "data": data,
                      "_csums": cs, "attrs": {}})
    d1 = _daemon_counters(cluster_dir, n_osds)
    c1 = perf("wire.zero").dump()
    n = len(data)
    verify = d1.get("scan_verify_bytes", 0) - \
        d0.get("scan_verify_bytes", 0)
    store = d1.get("scan_store_bytes", 0) - \
        d0.get("scan_store_bytes", 0)
    trusted = d1.get("trusted_csum_bytes", 0) - \
        d0.get("trusted_csum_bytes", 0)
    sent = c1.get("scan_send_bytes", 0) - c0.get("scan_send_bytes", 0)
    if not (n <= verify < 1.05 * n + 65536):
        return _fail(f"daemon verify scanned {verify} bytes of {n} "
                     f"(want exactly one pass)")
    if store:
        return _fail(f"store re-scanned {store} bytes despite "
                     f"trusted csums")
    if trusted < n:
        return _fail(f"only {trusted} bytes adopted trusted csums")
    if sent >= 65536:
        return _fail(f"client re-scanned {sent} bytes despite "
                     f"precomputed csums")

    # 2) shm negotiation + payload movement on the vstart pair
    blob = os.urandom(2 << 20)
    s0 = perf("wire.zero").dump().get("shm_bytes", 0)
    rc.put(1, "cw-shm", blob)
    if rc.get(1, "cw-shm") != blob:
        return _fail("shm-lane readback diverged")
    moved = perf("wire.zero").dump().get("shm_bytes", 0) - s0
    served = _daemon_counters(cluster_dir, n_osds) \
        .get("shm_frames_served", 0)
    if moved < len(blob):
        return _fail(f"shm ring moved only {moved} bytes "
                     f"(lane did not negotiate?)")
    if not served:
        return _fail("daemon served no shm frames")

    # 3) fallback: ring disabled -> same ops, zero ring traffic.
    # The option is read when an objecter builds its stream pools, so
    # the check uses a FRESH client handle (the existing one's pools
    # legitimately keep their negotiated rings).
    config().set("wire_shm_ring_kib", 0)
    rc2 = RemoteCluster(cluster_dir)
    try:
        f0 = perf("wire.zero").dump().get("shm_frames", 0)
        blob2 = os.urandom(1 << 20)
        rc2.aio_put(1, "cw-sock", blob2).get_return_value()
        if rc2.get(1, "cw-sock") != blob2:
            return _fail("socket-fallback readback diverged")
        if perf("wire.zero").dump().get("shm_frames", 0) != f0:
            return _fail("ring traffic with the lane disabled")
    finally:
        rc2.close()
        config().clear("wire_shm_ring_kib")

    rc.close()
    print(f"OK: ZeroWire verified (verify={verify}B store=0 "
          f"trusted={trusted}B shm_moved={moved}B)")
    return 0


def main(argv=None) -> int:
    import shutil
    import tempfile

    import ceph_tpu_torch
    from .vstart import Vstart, build_cluster_dir
    ap = argparse.ArgumentParser(
        prog="check_wire",
        description="ZeroWire's one crc pass per byte and its shm lane "
                    "against two OSD daemons")
    ap.add_argument("--device", default="cuda",
                    help="device of the client (default: cuda); the "
                         "daemons run on the CPU")
    args = ap.parse_args(argv)
    with ceph_tpu_torch.using_device(args.device):
        n_osds = 2
        tmp = tempfile.mkdtemp(prefix="check-wire-")
        d = os.path.join(tmp, "cluster")
        build_cluster_dir(d, n_osds=n_osds, osds_per_host=1, fsync=False)
        v = Vstart(d)
        try:
            v.start(n_osds, hb_interval=60.0, together=True)
            return run_checks(d, n_osds)
        finally:
            v.stop()
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
