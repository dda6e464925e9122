"""The port's process cluster against ceph_tpu.

``tools/vstart.py`` starts one mon and six OSD daemon processes of the
port (``python -m ceph_tpu_torch.cluster.daemon --device cpu``), and a
``RemoteCluster`` in this process, asked for the CPU, drives an RS(4,2)
bitsliced pool and a 3-replica pool through them: ``put``, ``put_many``,
``put_many_from_device`` staged and then ``flush_staged``, ``kill9`` of
two shard holders, a degraded ``get`` and ``get_many_to_device``, ``out``
and ``recover_ec_pool``.  The scenario runs once per cluster in a module
fixture and the tests read its record.  It is held against the JAX
package computed in-process on the same spec and payload: every shard's
bytes as the daemons hold them equal the reference codec's encode, the
up sets equal the reference ``OSDMap``'s, and every read equals its
payload.  One test runs the same scenario on a ``ceph_tpu`` vstart
cluster and compares the shard bytes and the deterministic recovery
stats.  Writes under load are retried with ``refresh_map`` until every
shard acks, as tests/test_process_cluster.py does; reads run once.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import ceph_tpu_torch

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OSDS = 6
K, M = 4, 2
SU = 4096                      # the EC pool's stripe unit
PROFILE = {"plugin": "jax", "k": str(K), "m": str(M),
           "layout": "bitsliced"}
POOLS = [{"id": 1, "name": "rep", "type": 1, "size": 3, "pg_num": 8,
          "crush_rule": 0},
         {"id": 2, "name": "ec", "type": 3, "size": K + M, "pg_num": 8,
          "crush_rule": 1, "erasure_code_profile": "default",
          "stripe_unit": SU}]
EC_NAMES = ["big", "m0", "m1", "m2", "m3", "s0", "s1"]


def _payloads():
    """Every payload of the scenario, from one seed."""
    rng = np.random.default_rng(2)
    big = rng.integers(0, 256, 30000, dtype=np.uint8).tobytes()
    many = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in (50000, 7000, 65536, 1)]
    # the device payload: 2 objects x 3 stripes of k chunks of SU bytes
    words = rng.integers(-2 ** 31, 2 ** 31, (2 * 3, K, SU // 4),
                         dtype=np.int64).astype(np.int32)
    rep = rng.integers(0, 256, 9000, dtype=np.uint8).tobytes()
    return big, many, words, rep


def _retry(fn, rc, ok=lambda r: True, tries=12):
    """A write: ``fn()`` until it returns without an IOError and ``ok``
    (every shard acked); a map refresh between tries (a loaded host can
    make a daemon miss one wire timeout or one heartbeat, and a write
    placed while the mon has it down misses that shard).  Reads are
    never retried."""
    last = None
    for _ in range(tries):
        try:
            r = fn()
            if ok(r):
                return r
            last = r
        except (OSError, IOError) as e:
            last = e
        time.sleep(0.5)
        try:
            rc.refresh_map()
        except (OSError, IOError):
            pass
    raise AssertionError(f"no full ack after {tries} tries: {last}")


def _wait_all_up(rc, polls=240):
    """Poll the mon until every OSD is up in its map, then refresh the
    client's map (a loaded host can make the mon mark a live daemon
    down for a heartbeat or two; it re-boots itself)."""
    for _ in range(polls):
        try:
            m = rc.mon_call({"cmd": "get_map"})
            if all(m["osd_up"][:N_OSDS]):
                rc.refresh_map()
                return
        except (OSError, IOError):
            pass
        time.sleep(0.25)
    raise AssertionError("the cluster never had every OSD up")


def _shard_bytes(rc, pool_id, names):
    """{name: [bytes of each shard]} as the daemons hold them."""
    io = rc.ec_backend(pool_id).io
    pool = rc.osdmap.pools[pool_id]
    return {nm: [io.get_shard_bytes(rc._pg_for(pool, nm), s, nm)
                 for s in range(K + M)] for nm in names}


def ioctx_ops(io_cls, rc):
    """tests/test_wire_gateways.py's IoCtx contract over the wire on the
    replicated pool: every answer, exceptions by name."""
    io = io_cls(rc, "rep")
    out = []

    def rec(fn):
        try:
            out.append(fn())
        except Exception as e:       # noqa: BLE001 — compared by name
            out.append(type(e).__name__)
    rec(lambda: io.write_full("o", b"abcdef"))
    rec(lambda: io.read("o"))
    rec(lambda: io.read("o", length=2, offset=3))
    rec(lambda: io.write("o", b"XY", offset=2))
    rec(lambda: io.read("o"))
    rec(lambda: io.write("hole", b"t", offset=5))
    rec(lambda: io.read("hole"))
    rec(lambda: io.stat("o").size)
    rec(lambda: sorted(io.list_objects()))
    rec(lambda: io.remove("o"))
    rec(lambda: io.read("o"))
    rec(lambda: io.remove("o"))
    rec(lambda: io.remove("hole"))
    return out


def run_scenario(d, v, rc, to_device, to_host, io_cls):
    """The scenario on a started cluster; returns its record.
    ``to_device``/``to_host`` move the device payload in and out of
    the client's package; ``io_cls`` is its RemoteIoCtx."""
    big, many, words, rep = _payloads()
    out = {"reads": {}}
    _wait_all_up(rc)
    out["rep_acks"] = _retry(lambda: rc.put(1, "r0", rep), rc,
                             ok=lambda a: a == 3)
    out["big_acks"] = _retry(lambda: rc.put(2, "big", big), rc,
                             ok=lambda a: a == K + M)
    mnames = [f"m{i}" for i in range(4)]
    full = K + M
    out["many_acks"] = _retry(
        lambda: rc.put_many(2, mnames, many), rc,
        ok=lambda r: all(a == full for a in r.values()))
    out["staged"] = _retry(
        lambda: rc.put_many_from_device(2, ["s0", "s1"], to_device(words),
                                        durable=False), rc,
        ok=lambda r: all(len(t) == full for t in r.values()))
    out["dirty_before_flush"] = len(list(rc.dev.dirty_items()))
    flushed = 0
    for _ in range(12):
        flushed += rc.flush_staged(2)
        if not any(True for _ in rc.dev.dirty_items()):
            break
        time.sleep(0.5)
        rc.refresh_map()
    out["flushed"] = flushed
    out["dirty_after_flush"] = len(list(rc.dev.dirty_items()))
    _wait_all_up(rc)
    out["shards"] = _shard_bytes(rc, 2, EC_NAMES)
    pool = rc.osdmap.pools[2]
    out["up"] = {pid: [rc.osdmap.pg_to_up_acting_osds(pid, pg)[0]
                       for pg in range(rc.osdmap.pools[pid].pg_num)]
                 for pid in (1, 2)}
    out["map"] = rc.mon_call({"cmd": "get_map"})
    out["ioctx"] = ioctx_ops(io_cls, rc)
    payload = {"big": big, "r0": rep, **dict(zip(mnames, many)),
               "s0": words[:3].tobytes(), "s1": words[3:].tobytes()}
    out["payload"] = payload

    # -- degraded: two shard holders of m0's PG killed, their staged
    # entries evicted so the client must decode
    up0 = rc._up(pool, rc._pg_for(pool, "m0"))
    victims = sorted(o for o in up0 if o >= 0)[:2]
    out["victims"] = victims
    for o in victims:
        v.kill9(f"osd.{o}")
    for key in list(rc.dev._entries):
        _pid, pg, _nm, shard = key
        up = rc._up(rc.osdmap.pools[key[0]], pg)
        if shard < len(up) and up[shard] in victims:
            rc.dev.evict(key)
    out["reads"]["degraded_get"] = {
        nm: rc.get(2, nm) == payload[nm] for nm in EC_NAMES}
    out["reads"]["degraded_rep"] = rc.get(1, "r0") == rep
    dev_reads = rc.get_many_to_device(2, ["s0", "s1"])
    out["reads"]["degraded_to_device"] = [
        to_host(w).tobytes() == payload[nm]
        for w, nm in zip(dev_reads, ["s0", "s1"])]

    # -- out, recover, read back
    for o in victims:
        rc.mon_call({"cmd": "mark_out", "osd": o})
    rc.refresh_map()
    stats = {}
    for _ in range(12):
        try:
            st = rc.recover_ec_pool(2)
        except (OSError, IOError):
            st = {"deferred_pgs": -1}
        for kk, val in st.items():
            if kk != "deferred_pgs":
                stats[kk] = stats.get(kk, 0) + val
        if not st.get("deferred_pgs"):
            break
        time.sleep(0.5)
        rc.refresh_map()
    out["recovery"] = stats
    rc.dev.clear()
    out["reads"]["after_recovery"] = {
        nm: rc.get(2, nm) == payload[nm] for nm in EC_NAMES}
    out["shards_after_recovery"] = _shard_bytes(rc, 2, EC_NAMES)
    return out


def _start(d, vstart_mod):
    vstart_mod.build_cluster_dir(d, n_osds=N_OSDS, osds_per_host=1,
                                 fsync=False, pools=POOLS)
    v = vstart_mod.Vstart(d)
    v.start(N_OSDS, hb_interval=0.5)
    return v


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    from ceph_tpu_torch.client.remote import RemoteCluster
    from ceph_tpu_torch.client.remote_ioctx import RemoteIoCtx
    from ceph_tpu_torch.tools import vstart
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    d = str(tmp_path_factory.mktemp("port") / "cluster")
    v = _start(d, vstart)
    try:
        rc = RemoteCluster(d, ec_profiles={"default": PROFILE})
        cmdlines = {n: open(f"/proc/{p.pid}/cmdline", "rb").read()
                    .split(b"\0") for n, p in v.procs.items()}
        try:
            bal = rc.mon_call({"cmd": "balancer_eval"})
        except Exception as e:        # noqa: BLE001 — the pinned reply
            bal = e
        rec = run_scenario(d, v, rc, torch.from_numpy,
                           lambda t: t.numpy(), RemoteIoCtx)
        rec.update(cmdlines=cmdlines, balancer=bal,
                   device=str(rc.ec_backend(2).codec.device))
        rc.close()
        yield rec
    finally:
        v.stop()
        ceph_tpu_torch.set_default_device(prev)


def _ref_codec():
    from ceph_tpu.ec import instance
    return instance().factory("jax", dict(PROFILE))


def _expected_shards(name, payload):
    """The reference codec's shards for one scenario object: ``big``
    is a single-stripe put, the rest are stripewise [S, k, W] puts."""
    import jax.numpy as jnp
    codec = _ref_codec()
    if name == "big":
        ch = codec.encode(set(range(K + M)), payload)
        return [np.asarray(ch[i]).tobytes() for i in range(K + M)]
    W = SU // 4
    S = max(1, -(-len(payload) // (K * SU)))
    buf = np.zeros(S * K * SU, np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    words = buf.view(np.int32).reshape(S, K, W)
    par = np.asarray(codec.encode_words_device(jnp.asarray(words)))
    return [np.ascontiguousarray(words[:, c]).tobytes() for c in range(K)] \
        + [np.ascontiguousarray(par[:, j]).tobytes() for j in range(M)]


def test_daemons_are_the_ports_and_ask_for_the_cpu(port_run):
    """vstart starts every daemon of the port with ``--device cpu``."""
    assert len(port_run["cmdlines"]) >= N_OSDS + 1
    for name, argv in port_run["cmdlines"].items():
        assert b"ceph_tpu_torch.cluster.daemon" in argv, name
        i = argv.index(b"--device")
        assert argv[i + 1] == b"cpu", name
    assert port_run["device"] == "cpu"


def test_every_write_acked_and_every_staged_shard_flushed(port_run):
    assert port_run["rep_acks"] == 3 and port_run["big_acks"] == K + M
    assert all(a == K + M for a in port_run["many_acks"].values())
    assert {nm: len(t) for nm, t in port_run["staged"].items()} == \
        {"s0": K + M, "s1": K + M}
    assert port_run["dirty_before_flush"] == 2 * (K + M)
    assert port_run["flushed"] == 2 * (K + M)
    assert port_run["dirty_after_flush"] == 0


@pytest.mark.parametrize("name", EC_NAMES)
def test_daemon_shards_equal_the_reference_encode(port_run, name):
    want = _expected_shards(name, port_run["payload"][name])
    assert port_run["shards"][name] == want


def test_up_sets_equal_the_reference_osdmap(port_run):
    """The client's placement of every PG of both pools equals the
    reference OSDMap built from the mon's map blob."""
    from ceph_tpu.cluster.osdmap import OSDMap, PGPool
    from ceph_tpu.placement.compiler import compile_crushmap
    blob = port_run["map"]
    m = OSDMap(compile_crushmap(blob["crush_text"]), epoch=blob["epoch"])
    m.mark_all_in_up()
    for i, up in enumerate(blob["osd_up"]):
        m.osd_up[i] = up
    for i, w in enumerate(blob["osd_weight"]):
        m.osd_weight[i] = w
    for p in blob["pools"]:
        m.add_pool(PGPool(**p))
    for pid, ups in port_run["up"].items():
        assert ups == [m.pg_to_up_acting_osds(pid, pg)[0]
                       for pg in range(m.pools[pid].pg_num)], pid


@pytest.mark.parametrize("step", ["degraded_get", "degraded_rep",
                                  "degraded_to_device", "after_recovery"])
def test_every_read_equals_its_payload(port_run, step):
    got = port_run["reads"][step]
    vals = got.values() if isinstance(got, dict) else \
        (got if isinstance(got, list) else [got])
    assert all(vals), got


def test_recovery_rebuilt_shards_and_they_equal_the_reference(port_run):
    st = port_run["recovery"]
    assert st["shards_rebuilt"] > 0 and st.get("unrecoverable", 0) == 0
    assert st["repair_bytes_fetched"] > 0
    for name in EC_NAMES:
        want = _expected_shards(name, port_run["payload"][name])
        got = port_run["shards_after_recovery"][name]
        for s in range(K + M):
            assert got[s] is None or got[s] == want[s], (name, s)


def test_remote_ioctx_contract_over_the_wire(port_run):
    """RemoteIoCtx (client/remote_ioctx.py) over the port's daemons
    answers as tests/test_wire_gateways.py expects."""
    assert port_run["ioctx"] == [
        None, b"abcdef", b"de", None, b"abXYef", None, b"\0" * 5 + b"t", 6,
        ["hole", "o", "r0"], None, "ObjectNotFound", "ObjectNotFound", None]


def test_balancer_eval_raises_not_implemented(port_run):
    """The mon's balancer advisor is not ported: the command raises
    NotImplementedError in the daemon and the reply names it."""
    err = port_run["balancer"]
    assert isinstance(err, RuntimeError)
    assert "NotImplementedError" in str(err) and "item 8" in str(err)


def test_daemon_device_defaults_to_cuda_and_raises_without_a_card(
        monkeypatch, tmp_path):
    from ceph_tpu_torch.cluster import daemon
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = ceph_tpu_torch.default_device()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            daemon.main(["osd", "--cluster-dir", str(tmp_path), "--id", "0"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            daemon.main(["mon", "--cluster-dir", str(tmp_path),
                         "--device", "cuda"])
    finally:
        ceph_tpu_torch.set_default_device(prev)


def test_client_defaults_to_the_card_and_raises_without_one(
        monkeypatch, tmp_path):
    from ceph_tpu_torch.client.remote import RemoteCluster
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cuda")
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RemoteCluster(str(tmp_path))
    finally:
        ceph_tpu_torch.set_default_device(prev)


def test_put_many_from_device_refuses_a_payload_off_the_codecs_device():
    """The device put takes int32 words on the codec's device; a host
    array or another dtype raises instead of being moved silently."""
    from ceph_tpu_torch.client.remote import RemoteCluster
    rc = RemoteCluster.__new__(RemoteCluster)

    class _Codec:
        device = torch.device("cpu")

    class _Be:
        codec = _Codec()

        def words_supported(self):
            return True

    class _Pool:
        type = 3

    rc.osdmap = type("M", (), {"pools": {2: _Pool()}})()
    rc.pool_snaps = {}
    rc.ec_backend = lambda pid: _Be()
    for bad in (np.zeros((1, K, 8), np.int32),
                torch.zeros((1, K, 8), dtype=torch.int64)):
        with pytest.raises(ValueError, match="int32 tensor"):
            rc.put_many_from_device(2, ["x"], bad)


def test_vstart_cli_start_status_stop(tmp_path):
    """``python -m ceph_tpu_torch.tools.vstart --dir D --osds N
    start|status|stop`` as the reference's CLI."""
    d = str(tmp_path / "c")
    env = dict(os.environ)

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.vstart",
             "--dir", d, *args], cwd=REPO, env=env, capture_output=True,
            text=True, timeout=120)
    r = cli("--osds", "2", "start")
    pids = json.loads(r.stdout)
    try:
        assert r.returncode == 0 and set(pids) >= {"mon", "osd.0", "osd.1"}
        st = None
        for _ in range(40):
            r = cli("status")
            st = json.loads(r.stdout) if r.returncode == 0 else None
            if st and st.get("n_up", st.get("num_up_osds")) == 2:
                break
            time.sleep(0.5)
        assert st is not None and r.returncode == 0, r.stderr
        assert "epoch" in st
    finally:
        r = cli("stop")
    assert r.returncode == 0 and "stopped" in r.stdout
    for pid in set(pids.values()):
        for _ in range(100):
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                break
            if open(f"/proc/{pid}/stat").read().split()[2] == "Z":
                break
            time.sleep(0.05)
        else:
            raise AssertionError(f"daemon {pid} still running")


def test_same_scenario_on_a_reference_cluster(port_run, tmp_path):
    """The same scenario on a ceph_tpu vstart cluster: identical shard
    bytes on the daemons, victims, and deterministic recovery stats."""
    import jax.numpy as jnp
    from ceph_tpu.client.remote import RemoteCluster
    from ceph_tpu.client.remote_ioctx import RemoteIoCtx
    from ceph_tpu.tools import vstart
    d = str(tmp_path / "cluster")
    v = _start(d, vstart)
    try:
        rc = RemoteCluster(d, ec_profiles={"default": PROFILE})
        ref = run_scenario(d, v, rc, jnp.asarray, np.asarray, RemoteIoCtx)
        rc.close()
    finally:
        v.stop()
    assert ref["shards"] == port_run["shards"]
    assert ref["up"] == port_run["up"]
    assert ref["victims"] == port_run["victims"]
    for key in ("shards_rebuilt", "repair_bytes_fetched", "unrecoverable"):
        assert ref["recovery"].get(key) == port_run["recovery"].get(key), key
    assert ref["reads"] == port_run["reads"]
    assert ref["ioctx"] == port_run["ioctx"]
