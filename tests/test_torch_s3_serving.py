"""The port's S3Serve against ceph_tpu's.

``rgw/serving.py``: the seeded zipf sampler and op schedule
(``ZipfKeys``, ``draw_op``, ``worker_rngs``), the SLO/QoS gate
(``evaluate_gate``) and the stock tenant profiles must give the same
values as the reference's on the same seeds and inputs; the dmClock
tenant classes of ``msg/scheduler.py`` dispatch the same sequence; the
sharded bucket index lists, places and reshards as the reference's does
(the index objects compared byte for byte).  The live legs run the
port's harness over the port's vstart daemons (each asked for the CPU)
with the tenants' handles on the CPU, under the reference's gates and
bounds unchanged: the gate green on a default-shaped profile, red on the
starved one, and the composed chaos soak (seeds 0 and 1) green with zero
acked-write loss.  Each test names its reference twin in
tests/test_s3_serving.py.
"""
import threading
import time

import pytest
import torch

import ceph_tpu_torch
from tests.torch_twin import (PORT, REF, assert_twin, gateway, outcome,
                              run_in)

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


# -------------------------------------------------------- schedule --

def test_zipf_same_seed_identical_sequence():
    """::test_zipf_same_seed_identical_sequence and
    ::test_zipf_skews_toward_hot_ranks: the same draws as the
    reference's sampler, seed for seed."""
    for n, theta, seed in ((64, 0.99, 7), (64, 0.99, 8), (64, 0.99, 0),
                           (48, 1.3, "0/gold/1"), (1, 0.5, 3)):
        a = PORT.serving.ZipfKeys(n, theta, seed=seed)
        b = REF.serving.ZipfKeys(n, theta, seed=seed)
        seq = [a.next_index() for _ in range(4000)]
        assert seq == [b.next_index() for _ in range(4000)]
        assert all(0 <= r < n for r in seq)
    z = PORT.serving.ZipfKeys(64, 0.99, seed=0)
    seq = [z.next_index() for _ in range(4000)]
    counts = [seq.count(r) for r in range(64)]
    assert counts[0] == max(counts) and sum(counts[:8]) > sum(counts[32:])
    assert outcome(lambda: PORT.serving.ZipfKeys(0))[:2] == \
        outcome(lambda: REF.serving.ZipfKeys(0))[:2] == \
        ("raised", "ValueError")


def _schedule(pkg, seed, t, widx, n=400):
    rng, zipf = pkg.serving.worker_rngs(seed, t, widx)
    return [pkg.serving.draw_op(t, widx, rng, zipf) for _ in range(n)]


@pytest.mark.parametrize("starve", [False, True])
def test_op_schedule_equals_the_reference(starve):
    """::test_op_schedule_deterministic_per_seed: every worker of every
    stock tenant draws the reference's (op, key) schedule, seeds 0-2."""
    port_t = PORT.serving.default_tenants(starve=starve)
    ref_t = REF.serving.default_tenants(starve=starve)
    assert [vars(t) for t in port_t] == [vars(t) for t in ref_t]
    for seed in (0, 1, 2):
        for pt, rt in zip(port_t, ref_t):
            for w in range(pt.clients):
                got = _schedule(PORT, seed, pt, w)
                assert got == _schedule(REF, seed, rt, w)
                for op, key in got:
                    if op != "get":
                        assert int(key[-5:]) % pt.clients == w
    t = PORT.serving.TenantSpec("alice", clients=3, n_keys=32)
    assert _schedule(PORT, 0, t, 0) != _schedule(PORT, 1, t, 0)
    assert _schedule(PORT, 0, t, 0) != _schedule(PORT, 0, t, 1)
    assert {"get", "put", "delete", "multipart"} <= {
        op for op, _ in _schedule(PORT, 0, t, 1)}


# ------------------------------------------------------------- gate --

def _gate_cases(pkg):
    T = pkg.serving.TenantSpec
    tenants = [T("gold", min_share=0.2, slo_p99_s=1.0, slo_p999_s=2.0)]
    good = {"gold": {"p99_s": 0.5, "p999_s": 1.0, "share": 0.5,
                     "attempted": 100, "errors": 0}}
    loose = [T("t", slo_p99_s=1.0, slo_p999_s=2.0)]
    m = {"t": {"p99_s": 5.0, "p999_s": 9.0, "share": 1.0,
               "attempted": 100, "errors": 5}}
    g = pkg.serving.evaluate_gate
    stock = pkg.serving.default_tenants()
    return [
        g(good, tenants),
        g({"gold": dict(good["gold"], p99_s=3.0)}, tenants),
        g({"gold": dict(good["gold"], p999_s=9.0)}, tenants),
        g({"gold": dict(good["gold"], share=0.05)}, tenants),
        g({"gold": dict(good["gold"], errors=7)}, tenants),
        g(good, tenants, data_loss=["k1: gone"]),
        g(m, loose), g(m, loose, slo_factor=10.0, error_budget=0.10),
        g(m, loose, slo_factor=1e9, error_budget=1.0, data_loss=["lost"]),
        g({}, stock),
        g({"gold": {"share": 0.09999, "attempted": 3, "errors": 0},
           "bronze": {"p99_s": 5.0001, "p999_s": None, "attempted": 0}},
          stock),
        g({"gold": {"share": 0.04}}, pkg.serving.default_tenants(True),
          slo_factor=20.0, error_budget=0.1)]


def test_gate_equals_the_reference():
    """::test_gate_green_and_every_failure_path and
    ::test_gate_relaxations_scale_latency_and_errors_not_loss: the same
    breach lists, case for case."""
    got = _gate_cases(PORT)
    assert got == _gate_cases(REF)
    assert got[0] == [] and [x["metric"] for x in got[1]] == ["p99_s"]
    assert [x["metric"] for x in got[2]] == ["p999_s"]
    assert got[3][0]["metric"] == "share" and got[3][0]["got"] == 0.05
    assert got[4][0]["metric"] == "error_frac"
    assert got[5][0]["metric"] == "data_loss"
    assert got[6] and got[7] == [] and got[8]


def test_starved_default_profile_is_gate_red_shaped():
    """::test_starved_default_profile_is_gate_red_shaped"""
    starved = {t.name: t for t in PORT.serving.default_tenants(starve=True)}
    assert starved["gold"].min_share > 0
    assert starved["gold"].qos_res == 0.0
    assert starved["gold"].clients < starved["bronze"].clients / 4
    cfg, ref = PORT.serving.ServeConfig(), REF.serving.ServeConfig()
    assert vars(cfg) == vars(ref)


# -------------------------------------------------- dmClock tenants --

def _dequeues(pkg, res):
    s = pkg.scheduler.MClockScheduler()
    tc, QoS = pkg.scheduler.tenant_class, pkg.scheduler.QoS
    s.set_qos(tc("gold"), QoS(reservation=res, weight=0.5))
    s.set_qos(tc("noisy"), QoS(reservation=0.0, weight=10.0))
    for i in range(200):
        s.enqueue(("g", i), klass=tc("gold"))
        s.enqueue(("n", i), klass=tc("noisy"))
    return [s.dequeue() for _ in range(100)]


def test_reserved_tenant_holds_floor_under_noisy_backlog():
    """::test_reserved_tenant_holds_floor_under_noisy_backlog and
    ::test_scheduler_tenant_classes_vivify_and_background_raises: the
    same dequeue sequence as the reference's, with and without the
    reservation."""
    tc = PORT.scheduler.tenant_class
    with_r, without = _dequeues(PORT, 0.4), _dequeues(PORT, 0.0)
    assert with_r == _dequeues(REF, 0.4) and without == _dequeues(REF, 0.0)
    gold = sum(1 for k, _ in with_r if k == tc("gold"))
    gold2 = sum(1 for k, _ in without if k == tc("gold"))
    assert gold >= 35 and gold2 < gold
    s = PORT.scheduler.MClockScheduler()
    s.enqueue("a", klass=tc("alice"))
    assert tc("alice") in s.qos
    with pytest.raises(KeyError):
        s.enqueue("x", klass="background_nonsense")


# ---------------------------------------------- sharded bucket index --

class DictIoctx:
    """tests/test_s3_serving.py's ``_SlowDictIoctx``: a dict-backed IoCtx
    whose reads and writes sleep ``delay`` seconds."""

    def __init__(self, delay=0.004):
        self.objs = {}
        self.delay = delay
        self._lock = threading.Lock()

    def read(self, oid):
        time.sleep(self.delay)
        with self._lock:
            if oid not in self.objs:
                raise KeyError(oid)
            return self.objs[oid]

    def write_full(self, oid, data):
        time.sleep(self.delay)
        with self._lock:
            self.objs[oid] = bytes(data)

    def remove(self, oid):
        with self._lock:
            self.objs.pop(oid, None)

    def list_objects(self):
        with self._lock:
            return sorted(self.objs)


def _hot_bucket_wall(pkg, num_shards, n_threads=8, puts=3):
    b = pkg.gw.RGWGateway(DictIoctx()).create_bucket(
        "hot", num_shards=num_shards)
    errs = []

    def writer(w):
        try:
            for i in range(puts):
                b.put_object(f"w{w}-{i}", b"x" * 64)
        except Exception as e:          # pragma: no cover
            errs.append(e)
    ts = [threading.Thread(target=writer, args=(w,))
          for w in range(n_threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    assert not errs
    return wall, [c["key"] for c in b.list_objects(max_keys=1000)["contents"]]


def test_hot_bucket_sharding_concurrency_and_listing_identity():
    """::test_hot_bucket_sharding_concurrency_and_listing_identity, the
    reference's bound unchanged"""
    wall1, listing1 = _hot_bucket_wall(PORT, 1)
    wall8, listing8 = _hot_bucket_wall(PORT, 8)
    assert listing1 == listing8 == _hot_bucket_wall(REF, 8)[1]
    assert listing1 == sorted(f"w{w}-{i}" for w in range(8)
                              for i in range(3))
    assert wall8 < wall1 / 1.8, (
        f"no concurrency win: 1 shard {wall1:.3f}s vs "
        f"8 shards {wall8:.3f}s")


def shard_placement(p):
    """::test_shard_placement_stable_and_counts_sum"""
    io = DictIoctx(delay=0.0)
    gw = p.gw.RGWGateway(io)
    b = gw.create_bucket("b", num_shards=5)
    keys = [f"k{i}" for i in range(60)]
    for k in keys:
        b.put_object(k, b"v")
    return [b.shard_entry_counts(), [b.get_object(k) for k in keys],
            gw.bucket_limit_check(max_entries_per_shard=10), io.objs]


def online_reshard(p):
    """::test_online_reshard_preserves_entries_and_redirects_writes"""
    io = DictIoctx(delay=0.0)
    gw = p.gw.RGWGateway(io)
    b = gw.create_bucket("r", num_shards=1)
    for i in range(30):
        b.put_object(f"k{i:02d}", f"v{i}".encode())
    before = b.list_objects(max_keys=1000)
    st = gw.reshard_bucket("r", 4)
    nb = gw.bucket("r")
    out = [before, st, nb.num_shards(), nb.list_objects(max_keys=1000),
           [nb.get_object(f"k{i:02d}") for i in range(30)]]
    nb.put_object("post-reshard", b"new")
    out += ["rgw.index.r" in io.objs, nb.shard_entry_counts()]
    b._LAYOUT_TTL_S = 0.0
    out.append(b.get_object("post-reshard"))
    out.append(gw.reshard_bucket("r", 2))
    return out + [gw.bucket("r").list_objects(max_keys=1000), io.objs]


def sharding_semantics_on_ec(p):
    """::test_check_serving_smoke: scripts/check_serving.py's sharding
    leg (1 and 8 index shards over the erasure-coded pool)"""
    gw = gateway(p, "ec")
    keys = [f"k{i:03d}" for i in range(40)]
    b1 = gw.create_bucket("one", num_shards=1)
    b8 = gw.create_bucket("eight", num_shards=8)
    for k in keys:
        b1.put_object(k, k.encode())
        b8.put_object(k, k.encode())
    return [b1.list_objects(max_keys=1000), b8.list_objects(max_keys=1000),
            b8.shard_entry_counts(), gw.bucket_limit_check()]


@pytest.mark.parametrize("scenario", [
    shard_placement, online_reshard, sharding_semantics_on_ec],
    ids=lambda f: f.__name__)
def test_index_equals_the_reference(scenario, monkeypatch):
    assert_twin(scenario, monkeypatch)


def test_index_holds_the_reference_contract(monkeypatch):
    rec, _ = run_in(PORT, shard_placement, monkeypatch)
    assert sum(rec[0]) == 60 and len(rec[0]) == 5
    row = next(r for r in rec[2] if r["bucket"] == "b")
    assert row["num_shards"] == 5 and row["fill_status"] in ("WARN", "OVER")
    rec, _ = run_in(PORT, online_reshard, monkeypatch)
    assert rec[1]["entries"] == 30 and rec[1]["num_shards"] == 4 and \
        rec[1]["old_num_shards"] == 1 and rec[2] == 4
    assert rec[3]["contents"] == rec[0]["contents"] and rec[5] is False
    assert sum(rec[6]) == 31 and rec[7][0] == b"new"
    rec, _ = run_in(PORT, sharding_semantics_on_ec, monkeypatch)
    keys = [[c["key"] for c in r["contents"]] for r in rec[:2]]
    assert keys[0] == keys[1] == [f"k{i:03d}" for i in range(40)]
    assert len(rec[2]) == 8 and sum(rec[2]) == 40


# ---------------------------------------------------- live daemons --

@pytest.fixture(scope="module")
def serve_cluster(tmp_path_factory):
    """The reference's module cluster, in the port: 3 OSD daemons with
    the gold tenant's dmClock class in the spec."""
    d = str(tmp_path_factory.mktemp("s3serve") / "cluster")
    PORT.vstart.build_cluster_dir(
        d, n_osds=3, osds_per_host=1, fsync=False,
        qos_tenants={"gold": {"res": 0.4, "wgt": 2.0, "lim": 0.0}})
    v = PORT.vstart.Vstart(d)
    v.start(3, hb_interval=0.25)
    yield d, v
    v.stop()


def test_bucket_reshard_and_limit_check_over_daemons(serve_cluster):
    """::test_bucket_reshard_and_limit_check_over_daemons, through the
    port's ``radosgw-admin bucket limit check`` and ``bucket reshard``
    (``ceph rgw POOL ...``, the reference's passthrough into the same
    verbs, waits for ``ceph_cli``: its ``bucket stats`` runs here through
    ``radosgw-admin`` itself)."""
    import io
    import json
    from ceph_tpu_torch.tools.radosgw_admin import main as rgw_main
    d, _v = serve_cluster
    rc = PORT.remote.RemoteCluster(d)
    try:
        io_ = PORT.remote_ioctx.RemoteIoCtx(rc, "rep")
        gw = PORT.gw.RGWGateway(io_)
        b = gw.create_bucket("wire-shards", num_shards=2)
        for i in range(12):
            b.put_object(f"obj{i:02d}", b"payload-%d" % i)
        buf = io.StringIO()
        assert rgw_main(["bucket", "limit", "check",
                         "--max-entries", "4"],
                        ioctx=io_, out=buf) == 0
        rows = {r["bucket"]: r for r in json.loads(buf.getvalue())}
        assert rows["wire-shards"]["num_shards"] == 2
        assert rows["wire-shards"]["fill_status"] in ("WARN", "OVER")
        buf = io.StringIO()
        assert rgw_main(["bucket", "reshard", "--bucket",
                         "wire-shards", "--num-shards", "6"],
                        ioctx=io_, out=buf) == 0
        st = json.loads(buf.getvalue())
        assert st["entries"] == 12 and st["num_shards"] == 6
        nb = gw.bucket("wire-shards")
        assert [c["key"] for c in nb.list_objects(max_keys=100)
                ["contents"]] == [f"obj{i:02d}" for i in range(12)]
        for i in range(12):
            assert nb.get_object(f"obj{i:02d}")[0] == b"payload-%d" % i
        assert sum(nb.shard_entry_counts()) == 12
        buf = io.StringIO()
        assert rgw_main(["bucket", "stats", "--bucket", "wire-shards"],
                        ioctx=io_, out=buf) == 0
        stats = json.loads(buf.getvalue())
        assert stats["wire-shards"]["num_objects"] == 12
        assert stats["wire-shards"]["num_shards"] == 6
    finally:
        rc.close()


def test_tenant_identity_reaches_daemon_scheduler(serve_cluster):
    """::test_tenant_identity_reaches_daemon_scheduler"""
    d, _v = serve_cluster
    tc = PORT.scheduler.tenant_class
    rc = PORT.remote.RemoteCluster(d)
    try:
        rc.set_tenant("gold")
        for i in range(6):
            rc.put(1, f"tenant-obj-{i}", b"x" * 512)
            assert rc.get(1, f"tenant-obj-{i}") == b"x" * 512
        rc.set_tenant(None)
        total = 0
        for o in range(3):
            sched = rc.osd_call(o, {"cmd": "status"})["scheduler"]
            assert tc("gold") in sched["classes"]
            total += sched["dequeued"].get(tc("gold"), 0)
        assert total > 0, "no daemon dispatched in the tenant class"
    finally:
        rc.close()


def test_serve_gate_green_on_default_config(serve_cluster):
    """::test_serve_gate_green_on_default_config"""
    d, v = serve_cluster
    T = PORT.serving.TenantSpec
    cfg = PORT.serving.ServeConfig(
        seed=0, n_osds=3, index_shards=4, bucket="green", tenants=[
            T("gold", clients=2, ops=30, qos_res=0.4, min_share=0.05),
            T("bronze", clients=3, ops=45, qos_res=0.0, qos_wgt=4.0)])
    r = PORT.serving.run_serve(cfg, cluster_dir=d, vstart=v)
    assert r["ok"], r["breaches"]
    for name, m in r["tenants"].items():
        assert m["samples"] and m["p99_s"] is not None, (name, m)
    shares = r["scheduler"]["tenant_shares"]
    assert shares.get("gold") and shares.get("bronze"), shares


def test_serve_starved_config_exits_red():
    """::test_serve_starved_config_exits_red, through the CLI entry
    (``serve_main --starve --json --device cpu``)"""
    import io
    import json
    tenants = PORT.serving.default_tenants(starve=True)
    assert [max(10, int(t.ops * 0.4)) for t in tenants] == [24, 144]
    buf = io.StringIO()
    rc = PORT.serving.serve_main(["--starve", "--osds", "3", "--shards",
                                  "4", "--ops-scale", "0.4", "--json",
                                  "--device", "cpu"], out=buf)
    r = json.loads(buf.getvalue())
    assert rc == 1 and not r["ok"]
    breach = next(b for b in r["breaches"]
                  if b["tenant"] == "gold" and b["metric"] == "share")
    assert breach["got"] < breach["bound"]


@pytest.fixture(scope="module")
def chaos_cluster(tmp_path_factory):
    """The reference's fsync=True chaos cluster, in the port."""
    d = str(tmp_path_factory.mktemp("s3chaos") / "cluster")
    PORT.vstart.build_cluster_dir(
        d, n_osds=3, osds_per_host=1, fsync=True,
        qos_tenants={"gold": {"res": 0.4, "wgt": 2.0, "lim": 0.0}})
    v = PORT.vstart.Vstart(d)
    v.start(3, hb_interval=0.25)
    yield d, v
    v.stop()


@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_serve_green(chaos_cluster, seed):
    """::test_chaos_serve_green: kill/revive, netsplit and powercycle
    under the tenants' traffic, the reference's relaxed gate and zero
    acked-write loss; the chaos schedule equals the reference's for the
    seed."""
    d, v = chaos_cluster
    T = PORT.serving.TenantSpec
    cfg = PORT.serving.ServeConfig(
        seed=seed, n_osds=3, index_shards=4, chaos=True,
        bucket=f"chaos{seed}",
        tenants=[T("gold", clients=2, ops=40, qos_res=0.4, min_share=0.05),
                 T("bronze", clients=3, ops=60, qos_res=0.0, qos_wgt=4.0)])
    r = PORT.serving.run_serve(cfg, cluster_dir=d, vstart=v)
    assert r["data_loss"] == [], r["data_loss"]
    assert r["ok"], r["breaches"]
    assert {k for k, _ in r["chaos_log"]} == {"kill", "netsplit",
                                              "powercycle"}
    assert r["total_ops"] >= 60
    # the schedule the seeded chaos driver draws, in the reference
    import random
    rng = random.Random(seed)
    kinds = ["kill", "netsplit", "powercycle"]
    rng.shuffle(kinds)
    assert [k for k, _ in r["chaos_log"]] == kinds
