"""Async-objecter smoke check of the port — the multi-stream wire data
path, verified end to end against live daemons.

The twin of ``scripts/check_async.py``.  Asserts the evidence the async
core claims:

  * completions FIRE: every ``aio_*`` completion resolves,
    ``set_complete_callback`` callbacks run, and overlapping same-object
    writes land in submission order;
  * OpTracker coverage: tracked ops carry the ``dispatched_wire`` event
    and the ``stage_wire_to_done_s`` histogram observes them;
  * the blocking shims are BYTE-IDENTICAL to async submission: the same
    objects written sync and async read back equal through both paths;
  * the stream pool actually striped: >= 1 live stream per touched
    daemon, submits accounted on ``perf("objecter.wire")``.

Three OSD daemons run on the CPU (``--device cpu``); the client runs on
``--device``, so on the card its frames' checksums run on K3's crc leg.

    python -m ceph_tpu_torch.tools.check_async                # the card
    python -m ceph_tpu_torch.tools.check_async --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys

COMPLETION_WAIT_S = 30.0     # one aio completion


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def run_checks(cluster_dir: str) -> int:
    from ..client.remote import RemoteCluster
    from ..client.remote_ioctx import RemoteIoCtx
    from ..common.op_tracker import tracker
    from ..common.perf_counters import perf

    rc = RemoteCluster(cluster_dir)
    io = RemoteIoCtx(rc, "rep")
    tracker().reset()

    # 1) completions fire, callbacks run, same-object ordering holds
    fired = []
    payloads = [bytes([0x61 + i]) * (1500 + i) for i in range(6)]
    comps = [io.aio_write_full("smoke-ord", p) for p in payloads]
    comps[0].set_complete_callback(lambda c: fired.append(c))
    for i, c in enumerate(comps):
        if c.wait_for_complete(COMPLETION_WAIT_S) != 0:
            return _fail(f"completion {i} did not signal")
        c.get_return_value()
        if not all(comps[j].is_complete() for j in range(i)):
            return _fail(f"op {i} completed before an earlier "
                         f"same-object op (ordering broken)")
    if not fired:
        return _fail("set_complete_callback never fired")
    if io.read("smoke-ord") != payloads[-1]:
        return _fail("same-object async writes did not land in "
                     "submission order")

    # 2) sync-vs-async byte identity through the shared core
    names = {f"smoke-{i}": os.urandom(2048 + 31 * i)
             for i in range(8)}
    sync_names = list(names)[:4]
    for n in sync_names:                     # blocking shim path
        io.write_full(n, names[n])
    cs = [io.aio_write_full(n, names[n])
          for n in list(names)[4:]]          # async path
    for c in cs:
        c.get_return_value()
    for n, want in names.items():
        got_sync = io.read(n)
        got_async = io.aio_read(n).get_return_value()
        if got_sync != want or got_async != want:
            return _fail(f"{n}: sync/async readback diverged "
                         f"(sync ok={got_sync == want}, "
                         f"async ok={got_async == want})")

    # 3) OpTracker: dispatched_wire event + stage histogram
    hist = tracker().dump_historic_ops()
    wire_ops = [o for o in hist["ops"]
                if any(e["event"] == "dispatched_wire"
                       for e in o["events"])]
    if not wire_ops:
        return _fail("no dispatched_wire event in dump_historic_ops")
    trk = perf("op_tracker").dump()
    if trk.get("stage_wire_to_done_s", {}).get("count", 0) == 0:
        return _fail("op_tracker.stage_wire_to_done_s: "
                     "no observations")

    # 4) the stream pool striped + accounted
    pw = perf("objecter.wire").dump()
    if not pw.get("submits"):
        return _fail("objecter.wire.submits never incremented")
    pool = rc.osdmap.pools[1]
    touched = {rc._up(pool, rc._pg_for(pool, n))[0] for n in names}
    for osd in touched:
        if rc.aio.streams_live(osd) < 1:
            return _fail(f"osd.{osd}: no live stream after the "
                         f"workload")

    rc.close()
    print(f"OK: async objecter verified ({len(wire_ops)} wire ops "
          f"tracked, {int(pw['submits'])} submits, "
          f"{len(touched)} stream pools)")
    return 0


def main(argv=None) -> int:
    import shutil
    import tempfile

    import ceph_tpu_torch
    from .vstart import Vstart, build_cluster_dir
    ap = argparse.ArgumentParser(
        prog="check_async",
        description="the async objecter's completions, ordering and "
                    "stream pools against three OSD daemons")
    ap.add_argument("--device", default="cuda",
                    help="device of the client (default: cuda); the "
                         "daemons run on the CPU")
    args = ap.parse_args(argv)
    with ceph_tpu_torch.using_device(args.device):
        tmp = tempfile.mkdtemp(prefix="check-async-")
        d = os.path.join(tmp, "cluster")
        build_cluster_dir(d, n_osds=3, osds_per_host=1, fsync=False)
        v = Vstart(d)
        try:
            v.start(3, hb_interval=60.0, together=True)
            return run_checks(d)
        finally:
            v.stop()
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
