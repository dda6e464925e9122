"""Messenger fault injection and session replay through the port's daemons.

Mirrors tests/test_msgr_inject.py against ``ceph_tpu_torch``: port
vstart clusters (every daemon asked for the CPU) and a ``RemoteCluster``
on the CPU.  With ``ms_inject_socket_failures`` armed a replicated
workload completes with no client-visible failure, every object reads
back, the listing converges, and the injections are proven by the status
field, the faultpoint registry and ``perf dump``; a ``daemon.hang_op``
armed over the asok fires and the op completes.  On a quiet cluster
(heartbeats every 60 s, shared by the module: no case kills a daemon) a
write whose reply frame is lost applies once, sync and async; overlapping
async writes to one object commit in submission order; a stale replay
cannot clobber a newer write.  The oracles are the PG log's length and
the daemons' dup counters, read as deltas around each case.
"""
import os
import time

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu_torch.common.admin import admin_request
from ceph_tpu_torch.common.perf_counters import perf

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

N_OSDS = 4


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


def _insist(fn, polls=40, tick=0.5):
    """Bounded retry against injected connection drops (each poll
    tolerates one drop or refusal)."""
    last = None
    for _ in range(polls):
        try:
            return fn()
        except (OSError, IOError) as e:
            last = e
            time.sleep(tick)
    raise AssertionError(f"call kept failing under injection: {last}")


def _start(d, n, **kw):
    from ceph_tpu_torch.tools.vstart import Vstart, build_cluster_dir
    hb = kw.pop("hb_interval")
    build_cluster_dir(d, n_osds=n, fsync=False, **kw)
    v = Vstart(d)
    v.start(n, hb_interval=hb)
    return v


def test_workload_survives_socket_failures(tmp_path):
    from ceph_tpu_torch.client.remote import RemoteCluster
    d = str(tmp_path / "cluster")
    v = _start(d, N_OSDS, osds_per_host=2, ms_inject_socket_failures=6,
               hb_interval=0.5)
    try:
        rc = RemoteCluster(d)
        rng = np.random.default_rng(11)
        blobs = {}
        for i in range(25):
            name = f"inj{i}"
            data = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
            assert rc.put(1, name, data) >= 1     # retries inside
            blobs[name] = data
        for name, data in blobs.items():
            assert rc.get(1, name) == data        # replica failover
        # listing completeness is promised only on a whole map:
        # converge on passes where every OSD is up, recovering between
        ok, detail = False, {}
        for _ in range(60):
            try:
                rc.refresh_map()
                st = rc.status()
                if st["n_up"] < N_OSDS:
                    detail = {"n_up": st["n_up"]}
                    time.sleep(0.5)
                    continue
                rc.recover_pool(1)
                listed = rc.list_objects(1)
                detail = {"missing": sorted(set(blobs) - set(listed)),
                          "extra": sorted(set(listed) - set(blobs))}
                ok = not detail["missing"] and not detail["extra"]
            except (OSError, IOError) as e:
                detail = {"err": repr(e)}
            if ok:
                break
            time.sleep(0.5)
        assert ok, f"listing never converged: {detail}"

        def status(o):
            try:
                return rc.osd_client(o).call({"cmd": "status"})
            except (OSError, IOError):
                rc.drop_osd_client(o)     # a fresh connection next poll
                raise
        # the status field first, then the registry's fire count: fires
        # only grow between the samples
        injected = fired = 0
        for osd in range(N_OSDS):
            n_status = int(_insist(lambda o=osd: status(o))
                           ["injected_failures"])
            st = admin_request(os.path.join(d, f"osd.{osd}.asok"),
                               {"prefix": "fault_injection"})["result"]
            n = int(st["fire_counts"].get("wire.inject_socket_failures", 0))
            assert n >= n_status, (osd, n, n_status)
            injected += n_status
            fired += n
        assert injected > 0, "no socket failures were injected"
        assert fired > 0, "registry fire counters recorded nothing"
        asok0 = os.path.join(d, "osd.0.asok")
        pd = admin_request(asok0, {"prefix": "perf dump"})["result"]
        asok_fires = pd.get("faults", {}).get(
            "wire.inject_socket_failures", 0)
        st0 = admin_request(asok0, {"prefix": "fault_injection"})["result"]
        assert asok_fires > 0
        assert st0["fire_counts"].get("wire.inject_socket_failures", 0) \
            >= asok_fires
        # runtime arming over the asok: stall one get_shard on osd.0
        r = admin_request(asok0, {
            "prefix": "fault_injection", "action": "arm",
            "name": "daemon.hang_op", "mode": "nth", "n": 1,
            "match": {"cmd": "get_shard"}, "params": {"seconds": 0.2}})
        assert r["result"]["armed"] == "daemon.hang_op"

        def probe():
            try:
                return rc.osd_client(0).call(
                    {"cmd": "get_shard", "coll": [1, 0], "oid": "0:x"})
            except (OSError, IOError):
                rc.drop_osd_client(0)
                raise
        _insist(probe)
        st0 = admin_request(asok0, {"prefix": "fault_injection"})["result"]
        assert st0["fire_counts"].get("daemon.hang_op", 0) >= 1
        rc.close()
    finally:
        v.stop()


@pytest.fixture(scope="module")
def quiet(tmp_path_factory):
    """Three OSD daemons with heartbeats every 60 s, so an armed
    reply-frame drop hits the test's op, not a peer ping."""
    from ceph_tpu_torch.client.remote import RemoteCluster
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    d = str(tmp_path_factory.mktemp("quiet") / "cluster")
    v = _start(d, 3, osds_per_host=1, hb_interval=60.0)
    try:
        rc = RemoteCluster(d)
        yield d, rc
        rc.close()
    finally:
        v.stop()
        ceph_tpu_torch.set_default_device(prev)


def _primary(rc, name):
    pool = rc.osdmap.pools[1]
    pg = rc._pg_for(pool, name)
    return pg, [o for o in rc._up(pool, pg) if o >= 0]


def _log_len(rc, prim, pg):
    r = rc.osd_call(prim, {"cmd": "pg_log", "coll": [1, pg],
                           "after": [0, 0]})
    return len(r["entries"])


def _replay_dups(asok):
    pd = admin_request(asok, {"prefix": "perf dump"})["result"]
    return pd.get("osd.session", {}).get("replay_dups", 0)


def _drop_next_reply(asok):
    """Drop the next MSG_REPLY (0x11) frame the daemon sends."""
    admin_request(asok, {"prefix": "fault_injection", "action": "arm",
                         "name": "wire.drop_frame", "match": {"type": 0x11},
                         "count": 1})


def _drop_fires(asok):
    st = admin_request(asok, {"prefix": "fault_injection"})["result"]
    return st["fire_counts"].get("wire.drop_frame", 0)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_lost_reply_op_applies_once(quiet, mode):
    """A write whose reply frame is lost applies exactly once: the
    retry (sync) or the async objecter's fresh-stream resubmit carries
    the same (session, seq) and the daemon returns the recorded
    completion.  One new PG-log entry per logical write."""
    d, rc = quiet
    name = f"sess-{mode}"
    rc.put(1, name, b"v1" * 500)
    pg, members = _primary(rc, name)
    prim = members[0]
    asok = os.path.join(d, f"osd.{prim}.asok")
    n0, dups0, fires0 = _log_len(rc, prim, pg), _replay_dups(asok), \
        _drop_fires(asok)
    resub0 = perf("objecter.wire").get("resubmits") or 0
    _drop_next_reply(asok)
    if mode == "sync":
        assert rc.put(1, name, b"v2" * 500) >= 1
    else:
        comp = rc.aio_put(1, name, b"v2" * 500)
        assert comp.get_return_value() >= 1
    assert rc.get(1, name) == b"v2" * 500
    assert _drop_fires(asok) - fires0 >= 1
    assert _replay_dups(asok) - dups0 >= 1
    assert _log_len(rc, prim, pg) == n0 + 1
    if mode == "async":
        assert (perf("objecter.wire").get("resubmits") or 0) - resub0 >= 1


def test_async_overlapping_writes_commit_in_submission_order(quiet):
    """Overlapping ``aio_write_full`` calls to one object commit in
    submission order; distinct objects land their own bytes."""
    from ceph_tpu_torch.client.remote_ioctx import RemoteIoCtx
    d, rc = quiet
    io = RemoteIoCtx(rc, "rep")
    payloads = [bytes([0x40 + i]) * (1200 + 7 * i) for i in range(8)]
    comps = [io.aio_write_full("ord-obj", p) for p in payloads]
    assert comps[-1].wait_for_complete(30.0) == 0
    for i, c in enumerate(comps):
        c.get_return_value()
        assert c.is_complete()
        assert all(comps[j].is_complete() for j in range(i))
    assert io.read("ord-obj") == payloads[-1]
    many = {f"ord-{i}": bytes([i]) * 1500 for i in range(6)}
    cs = [io.aio_write_full(n, p) for n, p in many.items()]
    for c in cs:
        c.get_return_value()
    for n, p in many.items():
        assert io.read(n) == p


def test_session_stale_replay_cannot_clobber_newer_write(quiet):
    """W1 (seq 1) applies, W2 (seq 2) supersedes it, then W1's replay
    arrives: the daemon returns W1's recorded completion, leaves W2's
    bytes in place and appends no log entry."""
    d, rc = quiet
    name = "manual-obj"
    pg, members = _primary(rc, name)
    prim = members[0]
    w1 = {"cmd": "put_object", "coll": [1, pg], "oid": f"0:{name}",
          "data": b"ver-one" * 100, "replicas": members,
          "session": "manual-sid", "seq": 1}
    r1 = rc.osd_call(prim, dict(w1))
    r2 = rc.osd_call(prim, {**w1, "data": b"ver-two" * 100, "seq": 2})
    assert r2["version"] != r1["version"]
    n2 = _log_len(rc, prim, pg)
    assert rc.osd_call(prim, dict(w1)) == r1
    assert _log_len(rc, prim, pg) == n2
    got = rc.osd_call(prim, {"cmd": "get_shard", "coll": [1, pg],
                             "oid": f"0:{name}"})
    assert bytes(got) == b"ver-two" * 100
    assert rc.osd_client(prim).call({"cmd": "status"})["sessions"] >= 1
