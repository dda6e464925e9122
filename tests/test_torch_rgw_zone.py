"""The port's multisite tier against ceph_tpu's.

``rgw/zone.py`` (realm, zonegroups, zones, periods and the period-driven
``PeriodSync``) and ``rgw/sync.py`` (per-shard bilog replay between
zones: markers per generation, the reshard cutover, drain-gated trim,
echo suppression, last-writer-wins, the lost-bilog seed).  Each scenario
is the twin of a reference test in tests/test_rgw_zone.py,
tests/test_geo_sync.py or tests/test_mirror_s3.py (named in its
docstring), run in both packages over tests/test_snaps.py's sims with
the same seeded tokens and clock (``tests/torch_twin.py``): the record
(sync reports, agent stats, listings, markers, exceptions by name) and
every object of every sim, the bilogs, sync markers and the index layout
after a reshard among them, must be equal.
"""
import pytest
import torch

import ceph_tpu_torch
from tests.torch_twin import (PORT, assert_twin, gateway, make_sim,
                              open_ioctx, outcome, run_in)

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


def _period(p):
    return None if p is None else (p.period_id, p.epoch, p.predecessor,
                                   p.master_zonegroup, p.all_zones())


# -------------------------------------------------------------- zone --

def realm_staging_and_commit(p):
    """tests/test_rgw_zone.py::test_realm_staging_and_commit"""
    r = p.zone.Realm(open_ioctx(p, make_sim(p)), "earth")
    out = [_period(r.current_period()), outcome(r.commit_period)[:2]]
    r.create_zonegroup("us", master=True)
    r.create_zone("us", "us-east", ["http://east:80"], master=True)
    r.create_zone("us", "us-west", ["http://west:80"])
    p1 = r.commit_period()
    out += [_period(p1), p1.zonegroups["us"].master_zone]
    r.set_endpoints("us", "us-west", ["http://west:8080"])
    out.append(_period(r.commit_period()))
    r.create_zone("us", "us-central")
    out += [_period(r.commit_period()), r.period_history()]
    return out


def realm_durability(p):
    """tests/test_rgw_zone.py::test_realm_durability"""
    io = open_ioctx(p, make_sim(p))
    r = p.zone.Realm(io, "earth")
    r.create_zonegroup("eu", master=True)
    r.create_zone("eu", "eu-de", master=True)
    pid = r.commit_period().period_id
    r2 = p.zone.Realm(io, "earth")
    cur = r2.current_period()
    r2.create_zone("eu", "eu-fr")
    r3 = p.zone.Realm(io, "earth")
    return [pid, _period(cur), cur.zonegroups["eu"].master_zone,
            sorted(r3.staging["eu"].zones),
            sorted(r3.current_period().zonegroups["eu"].zones)]


def zone_uniqueness_and_master_fallback(p):
    """tests/test_rgw_zone.py::test_zone_uniqueness_and_master_fallback"""
    r = p.zone.Realm(open_ioctx(p, make_sim(p)), "earth")
    r.create_zonegroup("g1", master=True)
    r.create_zone("g1", "z1", master=True)
    out = [outcome(lambda: r.create_zone("g1", "z1"))[:2]]
    r.create_zone("g1", "z2")
    r.remove_zone("g1", "z1")
    return out + [r.staging["g1"].master_zone,
                  outcome(lambda: r.remove_zone("g1", "zX"))[:2]]


def period_driven_sync(p):
    """tests/test_rgw_zone.py::test_period_driven_sync"""
    r = p.zone.Realm(open_ioctx(p, make_sim(p)), "earth")
    r.create_zonegroup("us", master=True)
    r.create_zone("us", "primary", master=True)
    r.create_zone("us", "backup")
    r.commit_period()
    gw_primary, gw_backup = gateway(p), gateway(p)
    ps = p.zone.PeriodSync(r, {"primary": gw_primary, "backup": gw_backup})
    b = gw_primary.create_bucket("photos")
    b.put_object("a.jpg", b"JPEG" * 100)
    b.put_object("b.jpg", b"JPEG2" * 100)
    out = [ps.sync_all(), gw_backup.bucket("photos").get_object("a.jpg")]
    b.delete_object("b.jpg")
    out.append(ps.sync_all())
    gw_other = gateway(p)
    p.zone.PeriodSync(r, {"primary": gw_primary, "other": gw_other}) \
        .sync_all()
    return out + [gw_other.list_buckets()]


def sync_without_period_refused(p):
    """tests/test_rgw_zone.py::test_sync_without_period_refused"""
    r = p.zone.Realm(open_ioctx(p, make_sim(p)), "nowhere")
    return outcome(p.zone.PeriodSync(r, {}).sync_all)[:2]


ZONE_SCENARIOS = [realm_staging_and_commit, realm_durability,
                  zone_uniqueness_and_master_fallback, period_driven_sync,
                  sync_without_period_refused]


@pytest.mark.parametrize("scenario", ZONE_SCENARIOS,
                         ids=lambda f: f.__name__)
def test_zone_equals_the_reference(scenario, monkeypatch):
    assert_twin(scenario, monkeypatch)


def test_zone_holds_the_reference_contract(monkeypatch):
    rec, _ = run_in(PORT, realm_staging_and_commit, monkeypatch)
    assert rec[0] is None and rec[1] == ("raised", "RealmError")
    p1, p2, p3 = rec[2], rec[4], rec[5]
    assert p1[1:4] == (1, "", "us") and rec[3] == "us-east"
    assert p2[0] == p1[0] and p2[1] == 2
    assert p3[0] != p1[0] and p3[1] == 1 and p3[2] == p1[0]
    assert rec[6] == [p3[0], p1[0]]
    rec, _ = run_in(PORT, period_driven_sync, monkeypatch)
    assert rec[0][("photos", "backup")] == {"puts": 2, "deletes": 0}
    assert rec[2][("photos", "backup")]["deletes"] == 1 and rec[3] == []


# ------------------------------------------------------------- sync --

def _zones(p):
    return gateway(p), gateway(p)


def _keys(b):
    return [c["key"] for c in b.list_objects(max_keys=1000)["contents"]]


def _markers(p, gw, bucket, zone):
    return p.gw.read_sync_state(gw.ioctx, bucket, zone)


def multisite_bucket_sync(p):
    """tests/test_mirror_s3.py::test_rgw_multisite_bucket_sync"""
    gw_a, gw_b = _zones(p)
    a = gw_a.create_bucket("assets")
    a.put_object("logo.png", b"PNG" * 500, metadata={"v": "1"})
    a.put_object("doomed.txt", b"bye")
    agent = p.sync.BucketSyncAgent(gw_a, gw_b, "assets", zone="zone-b")
    out = [agent.sync(), gw_b.bucket("assets").get_object("logo.png"),
           agent.sync()]
    a.delete_object("doomed.txt")
    a.put_object("logo.png", b"PNG2" * 500)
    out += [agent.sync(), gw_b.bucket("assets").get_object("logo.png"),
            outcome(lambda: gw_b.bucket("assets").get_object("doomed.txt"))
            [:2]]
    ag2 = p.sync.BucketSyncAgent(gw_a, gw_b, "assets", zone="zone-b")
    return out + [ag2.sync(), agent.stats, ag2.stats,
                  agent.committed_position(),
                  _markers(p, gw_a, "assets", "zone-b")]


def reshard_mid_sync_cutover(p):
    """tests/test_geo_sync.py::test_reshard_mid_sync_synced_cutover_no_full_sync"""
    gw_a, gw_b = _zones(p)
    a = gw_a.create_bucket("hot", num_shards=2)
    for i in range(8):
        a.put_object(f"k{i:02d}", f"v{i}".encode() * 40)
    agent = p.sync.BucketSyncAgent(gw_a, gw_b, "hot", zone="b",
                                   src_zone="a")
    out = [agent.sync()]
    for i in range(8, 12):
        a.put_object(f"k{i:02d}", f"v{i}".encode() * 40)
    a.delete_object("k00")
    out.append(gw_a.reshard_bucket("hot", 6))
    for i in range(12, 16):
        gw_a.bucket("hot").put_object(f"k{i:02d}", f"v{i}".encode() * 40)
    out += [agent.sync(), dict(agent.stats), _keys(gw_b.bucket("hot")),
            _keys(gw_a.bucket("hot")), agent.sync(),
            gw_a._read_buckets(), _markers(p, gw_a, "hot", "b"),
            gw_a.bucket("hot").shard_entry_counts()]
    return out


def fresh_agent_resumes(p):
    """tests/test_geo_sync.py::test_fresh_agent_resumes_from_persisted_markers"""
    gw_a, gw_b = _zones(p)
    a = gw_a.create_bucket("wal", num_shards=2)
    for i in range(6):
        a.put_object(f"k{i:02d}", b"x" * 64)
    ag1 = p.sync.BucketSyncAgent(gw_a, gw_b, "wal", zone="b", src_zone="a")
    out = [ag1.sync()]
    gw_a.reshard_bucket("wal", 4)
    for i in range(6, 10):
        gw_a.bucket("wal").put_object(f"k{i:02d}", b"y" * 64)
    ag2 = p.sync.BucketSyncAgent(gw_a, gw_b, "wal", zone="b", src_zone="a")
    return out + [ag2.sync(), ag2.stats, _keys(gw_b.bucket("wal")),
                  _keys(gw_a.bucket("wal")), _markers(p, gw_a, "wal", "b")]


def partition_mid_drain(p):
    """tests/test_geo_sync.py::test_partition_mid_drain_resumes_where_severed"""
    gw_a, gw_b = _zones(p)
    a = gw_a.create_bucket("cut", num_shards=1)
    for i in range(10):
        a.put_object(f"k{i:02d}", b"z" * 32)
    calls = {"n": 0}

    def sever_after_4(ctx):
        if ctx.get("src") != "zone.a" or ctx.get("dst") != "zone.b":
            return False
        calls["n"] += 1
        return calls["n"] > 4
    p.faults.arm("net.partition", mode="predicate", predicate=sever_after_4)
    ag1 = p.sync.BucketSyncAgent(gw_a, gw_b, "cut", zone="b", src_zone="a")
    out = [ag1.sync(), ag1.last_errors, _markers(p, gw_a, "cut", "b")]
    p.faults.disarm("net.partition")
    ag2 = p.sync.BucketSyncAgent(gw_a, gw_b, "cut", zone="b", src_zone="a")
    return out + [ag2.sync(), ag2.stats, _keys(gw_b.bucket("cut")),
                  _keys(a)]


def old_generation_bilogs_retire(p):
    """tests/test_geo_sync.py::test_old_generation_bilogs_retire_only_after_drain"""
    gw_a, gw_b = _zones(p)
    a = gw_a.create_bucket("gen", num_shards=2)
    for i in range(6):
        a.put_object(f"k{i}", b"d" * 16)
    agent = p.sync.BucketSyncAgent(gw_a, gw_b, "gen", zone="b",
                                   src_zone="a")
    gw_a.reshard_bucket("gen", 4)
    out = [gw_a._read_buckets()["gen"], gw_a.retire_drained_bilogs("gen")]
    agent.sync()
    return out + [gw_a._read_buckets()["gen"],
                  sorted(gw_a.ioctx.list_objects())]


def delete_bucket_refuses_until_drained(p):
    """tests/test_geo_sync.py::test_delete_bucket_refuses_until_peers_drain"""
    gw_a, gw_b = _zones(p)
    a = gw_a.create_bucket("doomed", num_shards=2)
    agent = p.sync.BucketSyncAgent(gw_a, gw_b, "doomed", zone="b",
                                   src_zone="a")
    a.put_object("k0", b"v")
    a.put_object("k1", b"v")
    a.delete_object("k0")
    a.delete_object("k1")
    out = [outcome(lambda: gw_a.delete_bucket("doomed"))[:3],
           agent.sync()]
    gw_a.delete_bucket("doomed")
    return out + [gw_a.list_buckets(), sorted(gw_a.ioctx.list_objects())]


def delete_bucket_force(p):
    """tests/test_geo_sync.py::test_delete_bucket_force_overrides_drain_gate"""
    gw_a, gw_b = _zones(p)
    a = gw_a.create_bucket("forced")
    p.sync.BucketSyncAgent(gw_a, gw_b, "forced", zone="b", src_zone="a")
    a.put_object("k", b"v")
    a.delete_object("k")
    out = [outcome(lambda: gw_a.delete_bucket("forced"))[:3]]
    gw_a.delete_bucket("forced", force=True)
    return out + [gw_a.list_buckets()]


def echo_suppression(p):
    """tests/test_geo_sync.py::test_echo_suppression_no_ping_pong"""
    gw_a, gw_b = _zones(p)
    a = gw_a.create_bucket("both", num_shards=2)
    a.put_object("seed", b"from-a")
    ab = p.sync.BucketSyncAgent(gw_a, gw_b, "both", zone="b", src_zone="a")
    out = [ab.sync()]
    ba = p.sync.BucketSyncAgent(gw_b, gw_a, "both", zone="a", src_zone="b")
    for _ in range(3):
        out += [ba.sync(), ab.sync()]
    return out + [ab.stats, ba.stats,
                  gw_a.bucket("both").get_object("seed"),
                  gw_b.bucket("both").get_object("seed")]


def conflict_last_writer_wins(p):
    """tests/test_geo_sync.py::test_conflict_resolves_last_writer_wins_on_source_mtime
    (the seeded clock orders B's write after A's, as the reference's
    20 ms sleep does)"""
    gw_a, gw_b = _zones(p)
    a = gw_a.create_bucket("clash")
    a.put_object("k", b"first")
    ab = p.sync.BucketSyncAgent(gw_a, gw_b, "clash", zone="b", src_zone="a")
    ab.sync()
    b = gw_b.bucket("clash")
    a.put_object("k", b"a-side")
    b.put_object("k", b"b-side-wins")
    ba = p.sync.BucketSyncAgent(gw_b, gw_a, "clash", zone="a", src_zone="b")
    out = []
    for _ in range(2):
        out += [ab.sync(), ba.sync()]
    return out + [gw_a.bucket("clash").get_object("k"),
                  gw_b.bucket("clash").get_object("k"), ab.stats, ba.stats]


def lost_bilog_entry(p):
    """tests/test_geo_sync.py::test_lost_bilog_entry_never_replicates"""
    gw_a, gw_b = _zones(p)
    a = gw_a.create_bucket("holes")
    a.put_object("kept", b"logged")
    p.faults.arm("rgw.bilog_lost_entry", mode="always", count=1)
    a.put_object("lost", b"acked but never logged")
    p.faults.disarm("rgw.bilog_lost_entry")
    agent = p.sync.BucketSyncAgent(gw_a, gw_b, "holes", zone="b",
                                   src_zone="a")
    return [p.faults.fire_counts()["rgw.bilog_lost_entry"], agent.sync(),
            gw_b.bucket("holes").get_object("kept"),
            outcome(lambda: gw_b.bucket("holes").get_object("lost"))[:3],
            a.get_object("lost")]


SYNC_SCENARIOS = [multisite_bucket_sync, reshard_mid_sync_cutover,
                  fresh_agent_resumes, partition_mid_drain,
                  old_generation_bilogs_retire,
                  delete_bucket_refuses_until_drained, delete_bucket_force,
                  echo_suppression, conflict_last_writer_wins,
                  lost_bilog_entry]


@pytest.mark.parametrize("scenario", SYNC_SCENARIOS,
                         ids=lambda f: f.__name__)
def test_sync_equals_the_reference(scenario, monkeypatch):
    assert_twin(scenario, monkeypatch)


def test_sync_holds_the_reference_contract(monkeypatch):
    rec, _ = run_in(PORT, reshard_mid_sync_cutover, monkeypatch)
    assert rec[0] == {"puts": 8, "deletes": 0}
    assert rec[2] == {"puts": 8, "deletes": 1}
    st = rec[3]
    assert (st["gen_cutovers"], st["full_syncs"], st["double_applies"]) == \
        (1, 0, 0)
    assert rec[4] == rec[5] and rec[6] == {"puts": 0, "deletes": 0}
    rec, _ = run_in(PORT, partition_mid_drain, monkeypatch)
    assert 0 < rec[0]["puts"] < 10 and "severed" in rec[1][0]
    assert rec[0]["puts"] + rec[3]["puts"] == 10 and rec[5] == rec[6]
    rec, _ = run_in(PORT, conflict_last_writer_wins, monkeypatch)
    assert rec[4][0] == rec[5][0] == b"b-side-wins"
    assert rec[6]["conflict_skips"] >= 1
    rec, _ = run_in(PORT, lost_bilog_entry, monkeypatch)
    assert rec[0] == 1 and rec[1] == {"puts": 1, "deletes": 0}
    assert rec[3][:2] == ("raised", "RGWError") and "NoSuchKey" in rec[3][2]
