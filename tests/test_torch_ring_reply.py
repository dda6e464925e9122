"""The daemon -> client shm reply ring through the port's daemons.

Mirrors tests/test_ring_reply.py against ``ceph_tpu_torch``: the ring
layer (sweep ownership by prefix, the flipped-record verdict of the host
scan and the device-crc scanner, a full ring refusing for the socket
fallback, the negotiation gates) is held against the reference on the
same inputs, and the live-daemon cases run on a port vstart cluster (two
OSD daemons asked for the CPU) with a ``RemoteCluster`` on the CPU:
same-host gets ride the reply ring and reclaim keeps it serving, with
the ring off bulk replies ride MSG_REPLY_SG with the trusted csums folded
into the frame crc, a ``wire.flip_bit`` armed inside a daemon drops the
connection and the retried get returns the right bytes, and the reply
rings of a kill -9'd daemon are swept when a client reconnects.  The two
shm-lane cases of tests/test_wire_zero.py (secure mode disables the lane;
the sweep reaps only dead-pid rings) close the file.
"""
import os
import subprocess
import tempfile
import time
import zlib

import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.common import options as ref_options
from ceph_tpu.msg import shm_ring as ref_shm_ring
from ceph_tpu.msg import wire as ref_wire
from ceph_tpu_torch.common import crcutil
from ceph_tpu_torch.common.admin import admin_request
from ceph_tpu_torch.common.options import config
from ceph_tpu_torch.common.perf_counters import perf
from ceph_tpu_torch.msg import shm_ring, wire

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

N_OSDS = 2


@pytest.fixture(autouse=True)
def _on_cpu(tmp_path):
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    for sub in ("p", "r"):          # one directory per package
        os.makedirs(str(tmp_path / sub), exist_ok=True)
    yield
    ceph_tpu_torch.set_default_device(prev)


# ------------------------------------------------------ sweep ownership ---

def sweep_ownership(ring_mod, d):
    p = subprocess.Popen(["true"])
    p.wait()                              # reaped: pid provably dead
    dead_req = os.path.join(d, f"zwring.osd.0.{p.pid}.aa00")
    dead_rep = os.path.join(d, f"zwreply.osd.0.{p.pid}.bb11")
    live_rep = os.path.join(d, f"zwreply.osd.1.{os.getpid()}.cc22")
    for f in (dead_req, dead_rep, live_rep):
        open(f, "wb").close()
    out = [ring_mod.sweep_stale(d, prefix="zwreply"),
           sorted(os.path.basename(f) for f in (dead_req, dead_rep,
                                                live_rep)
                  if os.path.exists(f))]
    out += [ring_mod.sweep_stale(d),
            [os.path.exists(f) for f in (dead_req, dead_rep, live_rep)]]
    return out


def test_sweep_prefix_separates_request_and_reply_ownership(tmp_path):
    port = sweep_ownership(shm_ring, str(tmp_path / "p"))
    ref = sweep_ownership(ref_shm_ring, str(tmp_path / "r"))
    assert port[0] == ref[0] == 1 and port[2] == ref[2] == 1
    assert port[3] == ref[3] == [False, False, True]
    assert [n.split(".")[0] for n in port[1]] == ["zwreply", "zwring"]


# -------------------------------------------- ring-layer verdict parity ---

def _poisoned_ring(ring_mod, data):
    d = tempfile.mkdtemp()
    ring = ring_mod.ShmRing.create(d, "osd.9", 1 << 20, prefix="zwreply")
    tok = ring.put(data, zlib.crc32(data))
    base = ring_mod.HDR_SPACE + tok.off + ring_mod._REC.size
    ring.mm[base + len(data) // 2] ^= 0x01
    return ring, tok


def ring_verdicts(ring_mod, wire_mod, cfg, data, clean):
    """The poisoned record's verdict and a clean record's Csums, with
    the receive verify on the host (``off``) and through the device-crc
    scanner (``on``)."""
    out = {}
    for mode in ("off", "on"):
        cfg.set("wire_device_crc", mode)
        try:
            ring, tok = _poisoned_ring(ring_mod, data)
            rdr = ring_mod.RingReader(ring.path, ring.size)
            try:
                rdr.read(tok.meta, scanner=wire_mod.receive_csums)
                verdict = "accepted"
            except wire_mod.WireError as e:
                verdict = type(e).__name__
            rdr.close()
            ring.close(unlink=True)
            d = tempfile.mkdtemp()
            ring = ring_mod.ShmRing.create(d, "x", 1 << 20,
                                           prefix="zwreply")
            tok = ring.put(clean, zlib.crc32(clean))
            rdr = ring_mod.RingReader(ring.path, ring.size)
            view, cs = rdr.read(tok.meta, scanner=wire_mod.receive_csums)
            out[mode] = (verdict, bytes(view) == clean, cs.block,
                         list(cs.subs), cs.length, cs.combined)
            rdr.close()
            ring.close(unlink=True)
        finally:
            cfg.clear("wire_device_crc")
    return out


def test_reply_ring_flip_verdict_parity_host_vs_device():
    """A flipped reply-ring record dies with the same verdict on the
    host scan and the device-crc scanner (the plain crc version on the
    CPU), a clean record gives the same Csums on both, and both equal
    the reference's."""
    data = os.urandom(200 * 1024 + 77)
    clean = os.urandom(100 * 1024)
    port = ring_verdicts(shm_ring, wire, config(), data, clean)
    ref = ring_verdicts(ref_shm_ring, ref_wire, ref_options.config(), data,
                        clean)
    assert port == ref
    assert port["off"] == port["on"]
    assert port["on"][:2] == ("WireError", True)


def full_ring(ring_mod):
    d = tempfile.mkdtemp()
    ring = ring_mod.ShmRing.create(d, "osd.9", 256 << 10, prefix="zwreply")
    toks = []
    while True:
        tok = ring.put(b"R" * 60_000, 0)
        if tok is None:
            break
        toks.append(tok)
    ring.free(toks[0])
    again = ring.put(b"S" * 50_000, 0)
    ring.close(unlink=True)
    return [len(toks), [t.off for t in toks], again is not None,
            again.off if again is not None else None]


def test_reply_ring_full_returns_none_for_socket_fallback():
    port = full_ring(shm_ring)
    assert port == full_ring(ref_shm_ring)
    assert port[0] >= 3 and port[2] is True


# --------------------------------------------------- negotiation gates ---

def want_reply(wire_mod, cfg, d):
    factory = lambda: (_ for _ in ()).throw(IOError("unused"))  # noqa
    out = [wire_mod.StreamPool(factory, size=1, name="t", shm_dir=None,
                               shm_bytes=0)._want_reply,
           wire_mod.StreamPool(factory, size=1, name="t", shm_dir=d,
                               shm_bytes=1 << 20)._want_reply]
    cfg.set("wire_reply_ring", False)
    try:
        out.append(wire_mod.StreamPool(factory, size=1, name="t",
                                       shm_dir=d,
                                       shm_bytes=1 << 20)._want_reply)
    finally:
        cfg.clear("wire_reply_ring")
    return out


def test_want_reply_requires_shm_and_option(tmp_path):
    port = want_reply(wire, config(), str(tmp_path / "p"))
    assert port == want_reply(ref_wire, ref_options.config(),
                              str(tmp_path / "r"))
    assert port == [False, True, False]


# ------------------------------------------------------- live daemons ---

@pytest.fixture(scope="module")
def live_cluster(tmp_path_factory):
    from ceph_tpu_torch.client.remote import RemoteCluster
    from ceph_tpu_torch.tools.vstart import Vstart, build_cluster_dir
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    d = str(tmp_path_factory.mktemp("rr") / "cluster")
    build_cluster_dir(d, n_osds=N_OSDS, osds_per_host=1, fsync=False)
    v = Vstart(d)
    v.start(N_OSDS, hb_interval=0.5)
    try:
        rc = RemoteCluster(d)
        yield d, v, rc
        rc.close()
    finally:
        v.stop()
        ceph_tpu_torch.set_default_device(prev)


def _get_retry(rc, pool, name, polls=40, tick=0.5):
    last = None
    for _ in range(polls):
        try:
            return rc.get(pool, name)
        except (OSError, IOError) as e:
            last = e
            time.sleep(tick)
    raise AssertionError(f"get kept failing: {last}")


def _put_retry(rc, pool, name, data, polls=40, tick=0.5):
    """A write until every replica acks (a loaded host can make the
    mon mark a live daemon down for a heartbeat)."""
    last = None
    for _ in range(polls):
        try:
            if rc.put(pool, name, data) == N_OSDS:
                return
        except (OSError, IOError) as e:
            last = e
        time.sleep(tick)
        try:
            rc.refresh_map()
        except (OSError, IOError):
            pass
    raise AssertionError(f"put never fully acked: {last}")


def _reply_files(d):
    return [fn for fn in os.listdir(d) if fn.startswith("zwreply.")]


def test_reply_ring_serves_gets_and_reclaims(live_cluster):
    """Bulk replies ride the mmap ring (the client's ``*_served``
    counters move by the payload size), and MSG_SHM_FREE reclaim keeps
    the ring serving an open-ended stream of gets."""
    d, v, rc = live_cluster
    data = os.urandom(2 << 20)
    _put_retry(rc, 1, "rrmove", data)
    c0 = perf("wire.zero").dump()
    assert rc.get(1, "rrmove") == data
    c1 = perf("wire.zero").dump()
    served = c1.get("shm_reply_bytes_served", 0) - \
        c0.get("shm_reply_bytes_served", 0)
    frames = c1.get("shm_reply_frames_served", 0) - \
        c0.get("shm_reply_frames_served", 0)
    assert served >= len(data), (c0, c1)
    assert frames >= 1
    assert _reply_files(d), "no zwreply ring file next to the socket"
    for i in range(10):
        assert rc.get(1, "rrmove") == data, f"get {i} failed"
    c2 = perf("wire.zero").dump()
    assert c2.get("shm_reply_bytes_served", 0) - \
        c1.get("shm_reply_bytes_served", 0) >= 10 * len(data)


def test_reply_sg_socket_fold_when_ring_disabled(live_cluster):
    """``wire_reply_ring`` off: bulk replies ride MSG_REPLY_SG on the
    socket with the store's trusted csums folded into the frame crc —
    identical bytes, no ring traffic, and the daemons' send path scans
    at most protocol noise."""
    from ceph_tpu_torch.client.remote import RemoteCluster
    d, v, rc = live_cluster
    data = os.urandom(2 << 20)
    _put_retry(rc, 1, "rrsg", data)
    config().set("wire_reply_ring", False)
    rc2 = RemoteCluster(d)
    try:
        c0 = perf("wire.zero").dump()
        d0 = crcutil.wire_zero_counters(d, N_OSDS, include_local=False)
        assert rc2.get(1, "rrsg") == data
        c1 = perf("wire.zero").dump()
        d1 = crcutil.wire_zero_counters(d, N_OSDS, include_local=False)
        assert c1.get("shm_reply_bytes_served", 0) == \
            c0.get("shm_reply_bytes_served", 0)
        sent = d1.get("scan_send_bytes", 0) - d0.get("scan_send_bytes", 0)
        assert sent < 65536, \
            f"daemon re-scanned {sent} reply bytes despite the fold"
    finally:
        rc2.close()
        config().clear("wire_reply_ring")


def _asok(d, osd, req):
    return admin_request(os.path.join(d, f"osd.{osd}.asok"), req)


def test_daemon_flip_bit_in_reply_ring_drops_connection(live_cluster):
    """``wire.flip_bit`` armed inside each daemon (site ``shm_ring``)
    poisons the next reply record: the client's resolve rejects it and
    the retried get returns the right bytes."""
    d, v, rc = live_cluster
    data = os.urandom(1 << 20)
    _put_retry(rc, 1, "rrflip", data)
    for osd in range(N_OSDS):
        r = _asok(d, osd, {
            "prefix": "fault_injection", "action": "arm",
            "name": "wire.flip_bit", "mode": "always", "count": 1,
            "match": {"site": "shm_ring"}})
        assert r["result"]["armed"] == "wire.flip_bit"
    try:
        assert _get_retry(rc, 1, "rrflip") == data
        fired = 0
        for osd in range(N_OSDS):
            st = _asok(d, osd, {"prefix": "fault_injection"})["result"]
            fired += int(st["fire_counts"].get("wire.flip_bit", 0))
        assert fired >= 1, "daemon-side flip never fired"
    finally:
        for osd in range(N_OSDS):
            _asok(d, osd, {"prefix": "fault_injection",
                           "action": "disarm", "name": "wire.flip_bit"})


def test_kill9_reply_rings_swept_on_reconnect(live_cluster):
    """kill -9 of a daemon orphans its reply rings; the retried get
    completes, and a client connecting afterwards sweeps the orphans."""
    from ceph_tpu_torch.client.remote import RemoteCluster
    d, v, rc = live_cluster
    data = os.urandom(1 << 20)
    _put_retry(rc, 1, "rrk9", data)
    assert rc.get(1, "rrk9") == data
    victim = 0
    v.kill9(f"osd.{victim}")
    assert _get_retry(rc, 1, "rrk9") == data
    v.start_osd(victim)
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            rc.refresh_map()
            if rc.status()["n_up"] == N_OSDS:
                break
        except (OSError, IOError):
            pass
        time.sleep(0.5)
    rc2 = RemoteCluster(d)
    try:
        assert rc2.get(1, "rrk9") == data
    finally:
        rc2.close()
    for fn in _reply_files(d):
        pid = int(fn.split(".")[-2])
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            raise AssertionError(
                f"orphan reply ring {fn} survived the reconnect sweep")
        except OSError:
            pass


# ------------------------------------- tests/test_wire_zero.py's lane ---

def secure_lane(ao_cls, cfg):
    cfg.set("objecter_wire_mode", "secure")
    try:
        ao = ao_cls(object())
        try:
            return [ao.shm_bytes, ao.reply_wanted]
        finally:
            ao.close()
    finally:
        cfg.clear("objecter_wire_mode")


def test_secure_mode_disables_shm_lane():
    """``objecter_wire_mode=secure`` promises sealed payloads: they
    never cross the plaintext mmap ring, either direction."""
    from ceph_tpu.cluster.async_objecter import AsyncObjecter as RefAO
    from ceph_tpu_torch.cluster.async_objecter import AsyncObjecter
    port = secure_lane(AsyncObjecter, config())
    assert port == secure_lane(RefAO, ref_options.config())
    assert port == [0, False]


def dead_pid_sweep(ring_mod, d):
    p = subprocess.Popen(["true"])
    p.wait()
    dead = os.path.join(d, f"zwring.osd.0.{p.pid}.abcd1234")
    live = os.path.join(d, f"zwring.osd.1.{os.getpid()}.ffff0000")
    other = os.path.join(d, "osd.0.sock")
    for f in (dead, live, other):
        open(f, "wb").close()
    return [ring_mod.sweep_stale(d),
            [os.path.exists(f) for f in (dead, live, other)]]


def test_sweep_stale_reaps_only_dead_pid_rings(tmp_path):
    port = dead_pid_sweep(shm_ring, str(tmp_path / "p"))
    assert port == dead_pid_sweep(ref_shm_ring, str(tmp_path / "r"))
    assert port == [1, [False, True, True]]
