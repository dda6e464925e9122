"""The port's object gateway against ceph_tpu's.

``rgw/gateway.py`` (buckets, the sharded index, listing, multipart, GC,
online reshard), ``rgw/users.py``, ``rgw/auth_s3.py`` (SigV4),
``rgw/http_frontend.py`` (S3 REST), ``rgw/swift_frontend.py`` (Swift
and TempAuth) and the robustness of the index reads.  Each scenario is
the twin of a reference test (named in its docstring): it runs in both
packages over tests/test_snaps.py's sim, the port's on the CPU, with the
same seeded tokens and clock (``tests/torch_twin.py``), and its record
and every object of every sim it built must be equal.  The gateway also
runs on the erasure-coded pool (bitsliced, the port's K1 path) with a
degraded read and ``recover_all``, and over the port's vstart daemons
(the gateway cases of tests/test_wire_gateways.py).
"""
import hashlib
import http.client
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu_torch.placement.crush_map import ITEM_NONE
from tests.torch_twin import (PORT, REF, assert_twin, gateway, make_sim,
                              open_ioctx, outcome, rados, run_in)

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


# ------------------------------------------------------------ gateway --

def bucket_and_object_flow(p):
    """tests/test_fs_rgw.py::test_rgw_bucket_and_object_flow"""
    gw = gateway(p)
    gw.create_bucket("photos")
    out = [outcome(lambda: gw.create_bucket("photos"))[:2]]
    b = gw.bucket("photos")
    payload = b"JPEGJPEG" * 512
    out.append(b.put_object("2024/01/cat.jpg", payload,
                            metadata={"content-type": "image/jpeg"}))
    out.append(b.get_object("2024/01/cat.jpg"))
    out.append(outcome(lambda: b.get_object("missing.jpg")))
    out.append(outcome(lambda: gw.delete_bucket("photos")))
    b.delete_object("2024/01/cat.jpg")
    gw.delete_bucket("photos")
    out += [gw.list_buckets(), gw.gc_list()]
    return out


def list_semantics(p):
    """tests/test_fs_rgw.py::test_rgw_list_semantics"""
    b = gateway(p).create_bucket("listing")
    for k in ["a/1", "a/2", "b/1", "b/sub/2", "top"]:
        b.put_object(k, k.encode())
    r1 = b.list_objects(max_keys=2)
    return [b.list_objects(prefix="", delimiter="/"),
            b.list_objects(prefix="b/", delimiter="/"), r1,
            b.list_objects(marker=r1["contents"][-1]["key"], max_keys=10),
            b.list_objects(prefix="a/", marker="a/1")]


def gc_reclaims_space(p):
    """tests/test_mirror_s3.py::test_rgw_gc_reclaims_space"""
    sim = make_sim(p)
    io = open_ioctx(p, sim)
    gw = p.gw.RGWGateway(io)
    b = gw.create_bucket("gcb")
    uid = b.initiate_multipart("obj")
    for n in (1, 2):
        b.upload_part(uid, n, b"x" * 1000)
    etag = b.complete_multipart(uid, [1, 2])
    parts = [b._mp_part_oid(uid, n) for n in (1, 2)]
    out = [etag, [io.read(o) for o in parts]]
    b.delete_object("obj")
    out += [gw.gc_list(), [io.read(o) for o in parts]]
    # not due yet at the enqueue time, due a day later
    out += [gw.gc_process(now=0.0), gw.gc_process(now=2e9), gw.gc_list(),
            [outcome(lambda o=o: io.read(o))[:2] for o in parts]]
    return out


def overwrite_and_abort(p):
    """tests/test_radosgw_admin.py::test_bucket_and_gc_commands (the
    gateway half): an overwrite defers the old generation to GC, an
    aborted upload's parts go with it."""
    gw = gateway(p)
    b = gw.create_bucket("data")
    b.put_object("a", b"x" * 100)
    b.put_object("b", b"y" * 50)
    b.put_object("a", b"z" * 100)
    uid = b.initiate_multipart("tmp")
    b.upload_part(uid, 1, b"orphan" * 100)
    aborted = b.abort_multipart(uid)
    return [b.head_object("a"), gw.gc_list(), aborted,
            gw.gc_process(now=2e9), gw.list_buckets(),
            b.shard_entry_counts(), gw.bucket_limit_check()]


def users_lifecycle(p):
    """tests/test_radosgw_admin.py::test_user_lifecycle, through the
    ``UserStore`` the CLI calls, and
    ::test_user_store_feeds_sigv4_frontend"""
    io = open_ioctx(p, make_sim(p))
    store = p.users.UserStore(io)
    rec = store.create("alice", display_name="Alice")
    out = [rec, outcome(lambda: store.create("alice"))[:3],
           store.list_users(), store.key_create("alice"),
           store.info("alice")]
    store.rm("alice")
    out.append(outcome(lambda: store.info("alice"))[:3])
    bob = store.create("bob")
    ak, sk = bob["keys"][0]["access_key"], bob["keys"][0]["secret_key"]
    users = store.auth_users()
    headers = {"Host": "x", **p.auth.sign_request(
        "GET", "/b/o", "", {"Host": "x"}, b"", ak, sk)}
    out += [users, p.auth.verify_request("GET", "/b/o", "", headers, b"",
                                         users),
            store.lookup_access_key(ak)]
    store.suspend("bob")
    out += [store.lookup_access_key(ak), store.auth_users()]
    store.suspend("bob", False)
    out.append(store.swift_users())
    return out


def corrupt_user_record(p):
    """tests/test_radosgw_admin.py::test_corrupt_user_record_not_clobbered"""
    io = open_ioctx(p, make_sim(p))
    store = p.users.UserStore(io)
    store.create("carol")
    io.write_full("rgw.user.carol", b"{torn-json")
    return [outcome(lambda: store.info("carol"))[:2],
            outcome(lambda: store.create("carol"))[:2]]


def kill_and_report(mon, sim, victim):
    """``victim`` dies, and its peers' reports mark it down in the map
    the clients follow."""
    sim.fail_osd(victim)
    for reporter in range(len(sim.osds)):
        if reporter != victim and mon.report_failure(victim, reporter):
            break
    assert not mon.osdmap.is_up(victim)


def out_and_commit(mon, victim):
    inc = mon.next_incremental()
    inc.new_weight[victim] = 0
    assert mon.commit_incremental(inc)


def ec_pool_bucket(p):
    """tests/test_wire_gateways.py::test_rgw_bucket_on_ec_pool on the sim:
    a bucket whose data and index live in the erasure-coded pool (k=2,
    m=1, bitsliced), objects across stripes, a multipart object, an
    online reshard, an OSD killed and every object read degraded, then
    out and ``recover_all``, and every object read again."""
    sim = make_sim(p)
    mon = p.mon.Monitor(sim.osdmap)
    gw = p.gw.RGWGateway(p.rados.Rados(sim, mon).connect().open_ioctx("ec"))
    b = gw.create_bucket("ec-bucket", num_shards=4)
    rng = np.random.default_rng(7)
    objs = {f"o{i:02d}/{'x' * (i % 3)}": rng.integers(
        0, 256, int(rng.integers(1, 20000)), dtype=np.uint8).tobytes()
        for i in range(12)}
    out = [b.put_object(k, v) for k, v in objs.items()]
    uid = b.initiate_multipart("mp.bin")
    for n in (1, 2, 3):
        b.upload_part(uid, n, bytes([n]) * 7000)
    out.append(b.complete_multipart(uid, [1, 2, 3]))
    out.append(gw.reshard_bucket("ec-bucket", 8))
    b = gw.bucket("ec-bucket")
    out.append(b.list_objects(max_keys=100, delimiter="/"))
    victim = sim.pg_up(sim.osdmap.pools[2], sim.object_pg(
        sim.osdmap.pools[2], "rgw_data.ec-bucket/o00/"))[0]
    kill_and_report(mon, sim, victim)
    out.append([b.get_object(k) for k in objs] + [b.get_object("mp.bin")])
    out_and_commit(mon, victim)
    out.append(sim.recover_all(2))
    out.append([b.get_object(k)[0] == v for k, v in objs.items()])
    return out


@pytest.mark.parametrize("scenario", [
    bucket_and_object_flow, list_semantics, gc_reclaims_space,
    overwrite_and_abort, users_lifecycle, corrupt_user_record,
    ec_pool_bucket], ids=lambda f: f.__name__)
def test_gateway_equals_the_reference(scenario, monkeypatch):
    assert_twin(scenario, monkeypatch)


def test_gateway_holds_the_reference_contract(monkeypatch):
    rec, _ = run_in(PORT, bucket_and_object_flow, monkeypatch)
    payload = b"JPEGJPEG" * 512
    assert rec[0] == ("raised", "RGWError")
    assert rec[1] == hashlib.md5(payload).hexdigest()
    assert rec[2][0] == payload and \
        rec[2][1]["meta"]["content-type"] == "image/jpeg"
    assert rec[3][:2] == ("raised", "RGWError")
    assert rec[4][:2] == ("raised", "RGWError")
    assert "photos" not in rec[5]
    rec, _ = run_in(PORT, ec_pool_bucket, monkeypatch)
    assert all(rec[-1]) and rec[-2]["shards_rebuilt"] > 0
    assert rec[13]["num_shards"] == 8 and rec[13]["entries"] == 13


# ------------------------------------------------------- robustness --

def index_read_survives_injected_eio(p):
    """tests/test_rgw_robustness.py::test_index_read_survives_injected_eio"""
    sim = make_sim(p)
    r = rados(p, sim)
    r._objecter.max_retries = 1
    b = p.gw.RGWGateway(r.open_ioctx("ec")).create_bucket("fragile")
    b.put_object("precious.bin", b"do not lose me" * 100)
    fires0 = p.faults.fire_counts().get("device.eio", 0)
    p.faults.arm("device.eio", mode="always", count=3)
    data, ent = b.get_object("precious.bin")
    return [data, ent, p.faults.fire_counts()["device.eio"] - fires0]


def test_index_read_survives_injected_eio(monkeypatch):
    rec = assert_twin(index_read_survives_injected_eio, monkeypatch)
    assert rec[0] == b"do not lose me" * 100 and rec[2] >= 3


def read_json_taxonomy(p):
    """tests/test_rgw_robustness.py::test_read_json_taxonomy"""
    class FlakyIoctx:
        def __init__(self, fail):
            self.fail, self.reads = fail, 0

        def read(self, oid):
            self.reads += 1
            if self.reads <= self.fail:
                raise IOError("transient")
            return b'{"k": 1}'

    class AbsentIoctx:
        def read(self, oid):
            raise KeyError(oid)

    flaky = FlakyIoctx(fail=2)
    return [p.gw._read_json(AbsentIoctx(), "x", {"d": 1}, "t"),
            p.gw._read_json(flaky, "x", {}, "t"), flaky.reads,
            outcome(lambda: p.gw._read_json(FlakyIoctx(99), "x", {}, "t"))]


def test_read_json_taxonomy(monkeypatch):
    rec = assert_twin(read_json_taxonomy, monkeypatch)
    assert rec[:3] == [{"d": 1}, {"k": 1}, 3] and rec[3][:2] == \
        ("raised", "RGWError")


# ----------------------------------------------------------- SigV4 --

def sigv4_replay_window(p):
    """tests/test_mirror_s3.py::test_sigv4_replay_window"""
    users = {"AK": {"secret": "s", "user": "u"}}
    stale = p.auth.sign_request("GET", "/b/k", "", {"host": "h"}, b"",
                                "AK", "s", amz_date="20200101T000000Z")
    stale["host"] = "h"
    fresh = p.auth.sign_request("GET", "/b/k", "", {"host": "h"}, b"",
                                "AK", "s")
    fresh["host"] = "h"
    return [stale, outcome(lambda: p.auth.verify_request(
        "GET", "/b/k", "", stale, b"", users)),
        p.auth.verify_request("GET", "/b/k", "", fresh, b"", users),
        p.auth.signing_key("s", "20200101").hex()]


def test_sigv4_replay_window(monkeypatch):
    rec = assert_twin(sigv4_replay_window, monkeypatch)
    assert rec[1][:2] == ("raised", "S3AuthError") and "replay" in rec[1][2]
    assert rec[2] == "u"


# -------------------------------------------------------- frontends --

def _url(url, method="GET", data=None, headers=None):
    """(status, selected headers, body) of one request."""
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        r = urllib.request.urlopen(req, timeout=10)
    except urllib.error.HTTPError as e:
        return e.code, {}, e.read()
    keep = {k.lower(): v for k, v in r.headers.items()
            if k.lower() in ("etag", "x-amz-meta-kind", "content-length")}
    return r.status, keep, r.read()


def _http(port, method, path, body=b"", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request(method, path, body=body, headers=headers or {})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    keep = {k: v for k, v in r.getheaders()
            if k.lower().startswith(("etag", "x-object-meta", "x-auth",
                                     "x-storage"))}
    return r.status, keep, data


def s3_http_flow(p):
    """tests/test_mirror_s3.py::test_s3_http_flow"""
    fe = p.http.S3Frontend(gateway(p))
    s3 = f"http://127.0.0.1:{fe.start(0)}"
    try:
        return [_url(f"{s3}/media", "PUT"),
                _url(f"{s3}/media/photos/cat.jpg", "PUT", b"JPEG" * 100,
                     {"x-amz-meta-kind": "pet"}),
                _url(f"{s3}/media/photos/cat.jpg"),
                _url(f"{s3}/media/photos/cat.jpg", "HEAD"),
                _url(f"{s3}/media/docs/a.txt", "PUT", b"A"),
                _url(f"{s3}/media?delimiter=/"),
                _url(f"{s3}/media?prefix=photos/"), _url(f"{s3}/"),
                _url(f"{s3}/media/missing.bin"),
                _url(f"{s3}/media", "DELETE"),
                _url(f"{s3}/media/photos/cat.jpg", "DELETE"),
                _url(f"{s3}/media/docs/a.txt", "DELETE"),
                _url(f"{s3}/media", "DELETE")]
    finally:
        fe.stop()


def s3_multipart_and_gc(p):
    """tests/test_mirror_s3.py::test_s3_multipart_and_gc"""
    fe = p.http.S3Frontend(gateway(p))
    s3 = f"http://127.0.0.1:{fe.start(0)}"
    try:
        out = [_url(f"{s3}/mp", "PUT")]
        body = _url(f"{s3}/mp/big.bin?uploads", "POST")[2].decode()
        uid = body.split("<UploadId>")[1].split("</UploadId>")[0]
        parts = {1: b"A" * 7000, 2: b"B" * 5000, 3: b"C" * 3000}
        out += [_url(f"{s3}/mp/big.bin?uploadId={uid}&partNumber={n}",
                     "PUT", d) for n, d in parts.items()]
        xml = "".join(f"<Part><PartNumber>{n}</PartNumber></Part>"
                      for n in parts)
        out += [_url(f"{s3}/mp/big.bin?uploadId={uid}", "POST",
                     f"<CompleteMultipartUpload>{xml}"
                     "</CompleteMultipartUpload>".encode()),
                _url(f"{s3}/mp/big.bin")]
        body = _url(f"{s3}/mp/tmp.bin?uploads", "POST")[2].decode()
        uid2 = body.split("<UploadId>")[1].split("</UploadId>")[0]
        out += [_url(f"{s3}/mp/tmp.bin?uploadId={uid2}&partNumber=1",
                     "PUT", b"orphan" * 100),
                _url(f"{s3}/mp/tmp.bin?uploadId={uid2}", "DELETE"),
                _url(f"{s3}/mp/big.bin", "DELETE"),
                _url(f"{s3}/mp/big.bin"), fe.gw.gc_list()]
        return out
    finally:
        fe.stop()


def s3_sigv4_auth(p):
    """tests/test_mirror_s3.py::test_s3_sigv4_auth"""
    fe = p.http.S3Frontend(gateway(p), users={
        "AKTEST": {"secret": "s3cr3t", "user": "alice"}})
    port = fe.start(0)
    base, host = f"http://127.0.0.1:{port}", f"127.0.0.1:{port}"

    def signed(method, path, data=b"", access="AKTEST", secret="s3cr3t"):
        hdrs = p.auth.sign_request(method, path, "", {"host": host}, data,
                                   access, secret)
        hdrs["Host"] = host
        return _url(f"{base}{path}", method, data or None, hdrs)
    try:
        out = [_url(f"{base}/secure", "PUT"), signed("PUT", "/secure"),
               signed("PUT", "/secure/k", b"payload"),
               signed("GET", "/secure/k"),
               signed("GET", "/secure/k", secret="WRONG"),
               signed("GET", "/secure/k", access="AKNOPE")]
        hdrs = p.auth.sign_request("PUT", "/secure/k2", "", {"host": host},
                                   b"original", "AKTEST", "s3cr3t")
        hdrs["Host"] = host
        out.append(_url(f"{base}/secure/k2", "PUT", b"tampered", hdrs))
        return out
    finally:
        fe.stop()


def swift_api_flow(p):
    """tests/test_striper_swift.py::test_swift_api_flow"""
    fe = p.swift.SwiftFrontend(gateway(p))
    port = fe.start()
    acct = "/v1/AUTH_test"
    try:
        return [
            _http(port, "PUT", f"{acct}/pics"),
            _http(port, "PUT", f"{acct}/pics"),
            _http(port, "PUT", f"{acct}/pics/cat.jpg", b"MEOW" * 100,
                  {"X-Object-Meta-Animal": "cat", "Content-Length": "400"}),
            _http(port, "GET", f"{acct}/pics/cat.jpg"),
            _http(port, "PUT", f"{acct}/pics/dir/deep.txt", b"d",
                  {"Content-Length": "1"}),
            _http(port, "GET", f"{acct}/pics"),
            _http(port, "GET", f"{acct}/pics?format=json"),
            _http(port, "GET", f"{acct}/pics?delimiter=/&format=json"),
            _http(port, "GET", f"{acct}?format=json"),
            _http(port, "DELETE", f"{acct}/pics"),
            _http(port, "DELETE", f"{acct}/pics/cat.jpg"),
            _http(port, "DELETE", f"{acct}/pics/dir/deep.txt"),
            _http(port, "DELETE", f"{acct}/pics"),
            _http(port, "GET", f"{acct}/pics")]
    finally:
        fe.stop()


def swift_tempauth(p):
    """tests/test_striper_swift.py::test_swift_tempauth"""
    fe = p.swift.SwiftFrontend(gateway(p), users={"test:tester": "secret"})
    port = fe.start()
    try:
        out = [_http(port, "GET", "/v1/AUTH_test"),
               _http(port, "GET", "/auth/v1.0",
                     headers={"X-Auth-User": "test:tester",
                              "X-Auth-Key": "wrong"})]
        ok = _http(port, "GET", "/auth/v1.0",
                   headers={"X-Auth-User": "test:tester",
                            "X-Auth-Key": "secret"})
        tok = ok[1]["X-Auth-Token"]
        ok[1]["X-Storage-Url"] = ok[1]["X-Storage-Url"].split("/v1/")[1]
        return out + [ok, _http(port, "PUT", "/v1/AUTH_test/c",
                                headers={"X-Auth-Token": tok}),
                      _http(port, "GET", "/v1/AUTH_test",
                            headers={"X-Auth-Token": tok}),
                      _http(port, "GET", "/v1/AUTH_test",
                            headers={"X-Auth-Token": "AUTH_tkbogus"})]
    finally:
        fe.stop()


def swift_and_s3_share_the_bucket_index(p):
    """tests/test_striper_swift.py::test_swift_and_s3_share_the_bucket_index"""
    gw = gateway(p)
    swift, s3 = p.swift.SwiftFrontend(gw), p.http.S3Frontend(gw)
    sp, s3p = swift.start(), s3.start()
    try:
        return [_http(sp, "PUT", "/v1/AUTH_test/shared"),
                _http(sp, "PUT", "/v1/AUTH_test/shared/o.bin", b"BOTH",
                      {"Content-Length": "4"}),
                _http(s3p, "GET", "/shared/o.bin"),
                _http(s3p, "GET", "/shared"),
                _http(sp, "GET", "/v1/AUTH_test/shared?format=json")]
    finally:
        swift.stop()
        s3.stop()


@pytest.mark.parametrize("scenario", [
    s3_http_flow, s3_multipart_and_gc, s3_sigv4_auth, swift_api_flow,
    swift_tempauth, swift_and_s3_share_the_bucket_index],
    ids=lambda f: f.__name__)
def test_frontend_equals_the_reference(scenario, monkeypatch):
    assert_twin(scenario, monkeypatch)


def test_frontends_hold_the_reference_contract(monkeypatch):
    s3, _ = run_in(PORT, s3_http_flow, monkeypatch)
    assert [r[0] for r in s3] == [200, 200, 200, 200, 200, 200, 200, 200,
                                  404, 409, 204, 204, 204]
    assert b"<CommonPrefixes><Prefix>photos/</Prefix>" in s3[5][2]
    assert s3[2][2] == b"JPEG" * 100 and s3[2][1]["x-amz-meta-kind"] == "pet"
    auth, _ = run_in(PORT, s3_sigv4_auth, monkeypatch)
    assert [r[0] for r in auth] == [403, 200, 200, 200, 403, 403, 403]
    assert b"SignatureDoesNotMatch" in auth[4][2] and \
        b"InvalidAccessKeyId" in auth[5][2] and auth[3][2] == b"payload"
    sw, _ = run_in(PORT, swift_api_flow, monkeypatch)
    assert [r[0] for r in sw] == [201, 202, 201, 200, 201, 200, 200, 200,
                                  200, 409, 204, 204, 204, 404]
    assert any(e.get("subdir") == "dir/" for e in json.loads(sw[7][2]))
    ta, _ = run_in(PORT, swift_tempauth, monkeypatch)
    assert [r[0] for r in ta] == [401, 401, 200, 201, 200, 401]
    both, _ = run_in(PORT, swift_and_s3_share_the_bucket_index, monkeypatch)
    assert both[2][:1] == (200,) and both[2][2] == b"BOTH"


# ------------------------------------------------------ over daemons --

@pytest.fixture(scope="module")
def port_cluster(tmp_path_factory):
    """tests/test_wire_gateways.py's module cluster in the port: 4 OSD
    daemons (each asked for the CPU) and a RemoteCluster on the CPU."""
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    d = str(tmp_path_factory.mktemp("wiregw") / "cluster")
    PORT.vstart.build_cluster_dir(d, n_osds=4, osds_per_host=2, fsync=False)
    v = PORT.vstart.Vstart(d)
    v.start(4, hb_interval=0.25)
    try:
        rc = PORT.remote.RemoteCluster(d)
        yield d, v, rc
        rc.close()
    finally:
        v.stop()
        ceph_tpu_torch.set_default_device(prev)


class _WithPut:
    """A cluster handle with its ``put`` replaced."""

    def __init__(self, rc, put):
        self._inner, self.put = rc, put

    def __getattr__(self, name):
        return getattr(self._inner, name)


class AckedIoCtx(PORT.remote_ioctx.RemoteIoCtx):
    """The port's RemoteIoCtx whose writes run again, after a map
    refresh, until every copy holds them (the ack retry of
    tests/test_process_cluster.py): the map must show each of the
    ``live`` daemons the test keeps running as up, at one epoch before
    the put and after it, and every member of the object's up set must
    hold the written bytes (every shard must ack, on an EC pool).  Under
    load the mon can mark a live daemon down for a heartbeat, and a
    write placed then lands on fewer copies (ROADMAP C5).  Reads run
    once, and nothing is recovered, so a write that lost a copy still
    shows."""

    def __init__(self, rc, pool_name, live):
        super().__init__(rc, pool_name)
        self.live = live
        self.cluster = rc
        self._rc = _WithPut(rc, self._acked_put)

    def _all_live_up(self):
        """The refreshed map's epoch if it shows ``live`` OSDs up."""
        self.cluster.refresh_map()
        om = self.cluster.osdmap
        if int(om.osd_up[:om.max_osd].sum()) == self.live:
            return om.epoch
        return None

    def _on_every_copy(self, pool, oid, data, acks):
        if pool.type == PORT.om.POOL_ERASURE:
            return acks == pool.size
        rc = self.cluster
        pg = rc._pg_for(pool, oid)
        up = rc.osdmap.pg_to_up_acting_osds(pool.id, pg)[0]
        try:
            held = [rc.osd_call(o, {"cmd": "get_shard",
                                    "coll": [pool.id, pg],
                                    "oid": f"0:{oid}"})
                    for o in up if o != ITEM_NONE]
        except (OSError, IOError):
            return False
        return all(h is not None and bytes(h) == data for h in held)

    def _acked_put(self, pool_id, oid, data, **kw):
        for _ in range(60):
            epoch = self._all_live_up()
            if epoch is not None:
                acks = self.cluster.put(pool_id, oid, data, **kw)
                if self._all_live_up() == epoch and self._on_every_copy(
                        self.cluster.osdmap.pools[pool_id], oid,
                        bytes(data), acks):
                    return acks
            time.sleep(0.5)
        raise IOError(f"{oid}: not on every copy with {self.live} "
                      f"daemons running")


def test_rgw_over_daemons(port_cluster, monkeypatch):
    """tests/test_wire_gateways.py::test_rgw_over_daemons in the port:
    the bucket index and ETag served from OSD processes, and the
    gateway still reading and writing after an OSD SIGKILL; its
    listings equal the reference gateway's over the sim for the same
    operations (but for the mtimes and the data generations, which the
    wire client's own draws move)."""
    _d, v, rc = port_cluster
    io = AckedIoCtx(rc, "rep", live=4)
    gw = PORT.gw.RGWGateway(io)
    b = gw.create_bucket("wire-bucket")
    etag = b.put_object("hello.txt", b"wire!" * 200,
                        metadata={"who": "wire"})
    data, ent = b.get_object("hello.txt")
    assert etag == hashlib.md5(b"wire!" * 200).hexdigest()
    assert data == b"wire!" * 200 and ent["meta"] == {"who": "wire"}
    listing = b.list_objects()
    assert [c["key"] for c in listing["contents"]] == ["hello.txt"]
    # degraded: kill one OSD, the gateway keeps serving
    v.kill9("osd.1")
    io.live = 3
    assert b.get_object("hello.txt")[0] == b"wire!" * 200
    b.put_object("degraded.txt", b"still-writable")
    assert b.get_object("degraded.txt")[0] == b"still-writable"
    after = b.list_objects()

    def on_sim(p):
        bb = gateway(p).create_bucket("wire-bucket")
        bb.put_object("hello.txt", b"wire!" * 200, metadata={"who": "wire"})
        first = bb.list_objects()
        bb.put_object("degraded.txt", b"still-writable")
        return first, bb.list_objects()

    ref, _ = run_in(REF, on_sim, monkeypatch)

    def strip(contents):
        # the wall clock's mtime and the random data generation aside
        return [{k: v for k, v in c.items() if k not in ("mtime", "gen")}
                for c in contents]
    for got, want in ((listing, ref[0]), (after, ref[1])):
        assert strip(got["contents"]) == strip(want["contents"])
        assert got["common_prefixes"] == want["common_prefixes"]


def test_rgw_bucket_on_ec_pool(tmp_path):
    """tests/test_wire_gateways.py::test_rgw_bucket_on_ec_pool in the
    port: bucket data erasure-coded (k=4, m=2, bitsliced) across six
    daemons through the wire client's EC put and get, read back after
    two OSDs die."""
    d = str(tmp_path / "cluster")
    PORT.vstart.build_cluster_dir(
        d, n_osds=6, osds_per_host=1, fsync=False,
        pools=[{"id": 1, "name": "rep", "type": 1, "size": 3,
                "pg_num": 8, "crush_rule": 0},
               {"id": 2, "name": "ecdata", "type": 3, "size": 6,
                "pg_num": 8, "crush_rule": 1,
                "erasure_code_profile": "default"}])
    v = PORT.vstart.Vstart(d)
    v.start(6, hb_interval=0.25)
    try:
        c = PORT.remote.RemoteCluster(d, ec_profiles={
            "default": {"plugin": "jax", "k": "4", "m": "2",
                        "layout": "bitsliced"}})
        gw = PORT.gw.RGWGateway(AckedIoCtx(c, "ecdata", live=6))
        b = gw.create_bucket("ec-bucket")
        payload = bytes(range(256)) * 64
        b.put_object("striped.bin", payload)
        assert b.get_object("striped.bin")[0] == payload
        # m = 2 OSDs die; k = 4 survivors still decode the bucket data
        v.kill9("osd.0")
        v.kill9("osd.3")
        assert b.get_object("striped.bin")[0] == payload
        c.close()
    finally:
        v.stop()


# ------------------------------------------------ reshard and writers --

def stale_handle_write_after_reshard(p):
    """A handle taken before an online reshard writes inside its layout
    TTL: the reference's entry goes to the removed old-generation index
    object and the key drops out of the listing; the port's writer sees
    its gateway's reshard under the shard lock and writes the new
    generation (ROADMAP C9)."""
    gw = gateway(p)
    gw.create_bucket("r", num_shards=8)
    b = gw.bucket("r")
    b.put_object("before", b"1")
    gw.reshard_bucket("r", 16)
    b.put_object("after", b"2")
    nb = gw.bucket("r")
    return [[c["key"] for c in nb.list_objects()["contents"]],
            outcome(lambda: nb.get_object("after"))[:2],
            sum(nb.shard_entry_counts())]


def test_stale_handle_write_after_reshard_lands_in_the_new_generation(
        monkeypatch):
    ref, _ = run_in(REF, stale_handle_write_after_reshard, monkeypatch)
    port, _ = run_in(PORT, stale_handle_write_after_reshard, monkeypatch)
    assert ref == [["before"], ("raised", "RGWError"), 1]
    assert port[0] == ["after", "before"] and port[2] == 2
    assert port[1][0] == "ok" and port[1][1][0] == b"2"


def test_writers_racing_an_online_reshard_keep_every_write(monkeypatch):
    """Writers on their own handles while the bucket reshards from 8 to 16
    shards, with a short switch interval: every acked put is listed and
    readable after it (the card's smoke does the same on the
    erasure-coded pool)."""
    import sys
    import threading

    def scenario(p):
        gw = gateway(p)
        gw.create_bucket("live", num_shards=8)
        for i in range(40):
            gw.bucket("live").put_object(f"pre{i:02d}", b"p%d" % i)
        errs = []

        def writer(w):
            try:
                b = gw.bucket("live")
                for i in range(12):
                    b.put_object(f"w{w}-{i:02d}", b"v%d" % i)
            except Exception as e:      # noqa: BLE001 — reported
                errs.append(repr(e))
        ts = [threading.Thread(target=writer, args=(w,)) for w in range(8)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for t in ts:
                t.start()
            st = gw.reshard_bucket("live", 16)
            for t in ts:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in ts)
        nb = gw.bucket("live")
        keys = [c["key"] for c in nb.list_objects(max_keys=1000)["contents"]]
        return errs, st["num_shards"], keys, [
            nb.get_object(f"w{w}-{i:02d}")[0] for w in range(8)
            for i in range(12)]
    errs, shards, keys, got = run_in(PORT, scenario, monkeypatch)[0]
    assert errs == [] and shards == 16
    assert keys == sorted([f"pre{i:02d}" for i in range(40)] +
                          [f"w{w}-{i:02d}" for w in range(8)
                           for i in range(12)])
    assert got == [b"v%d" % i for _w in range(8) for i in range(12)]
