"""The port's OSDMap against ceph_tpu's: the object -> PG -> OSD pipeline.

Each map is built in the reference package and carried across with
``convert.osdmap_state`` / ``osdmap_from_state``; the port then answers
``map_pgs_batch`` (its batched mapper on the CPU) and
``pg_to_up_acting_osds`` (scalar), and both must equal the reference's,
exactly, with pg_upmap, pg_upmap_items, pg_temp, primary_temp, primary
affinity and out/down OSDs in play.  Mirrors tests/test_osdmap.py.
"""
import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.cluster.osdmap import (MAX_PRIMARY_AFFINITY, OSDMap, PGPool,
                                     POOL_ERASURE, POOL_REPLICATED)
from ceph_tpu.placement.builder import TYPE_HOST, build_flat_cluster
from ceph_tpu.placement.crush_map import (
    ITEM_NONE, RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP, RULE_EMIT,
    RULE_TAKE, Rule)
from ceph_tpu_torch import convert
from ceph_tpu_torch.cluster import osdmap as port_osdmap

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


def make_osdmap(seed=0):
    cmap, root = build_flat_cluster(n_hosts=6, osds_per_host=4, seed=seed)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    m = OSDMap(cmap)
    m.mark_all_in_up()
    m.add_pool(PGPool(id=1, name="rbd", type=POOL_REPLICATED, size=3,
                      pg_num=64, crush_rule=0))
    m.add_pool(PGPool(id=2, name="ecpool", type=POOL_ERASURE, size=5,
                      pg_num=32, crush_rule=1))
    return m


def exceptions(m, seed):
    """Out and down OSDs, upmaps, temps and primary affinity, drawn from
    np.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    n = m.max_osd
    for o in rng.choice(n, 2, replace=False):
        m.osd_weight[o] = 0                         # out
    m.osd_up[int(rng.integers(n))] = False          # down
    m.osd_weight[int(rng.integers(n))] = 0x8000     # half in
    aff = rng.integers(0, MAX_PRIMARY_AFFINITY + 1, n)
    m.osd_primary_affinity[:] = np.where(rng.random(n) < 0.4, aff,
                                         MAX_PRIMARY_AFFINITY)
    m.pg_upmap[(1, 3)] = [int(v) for v in rng.choice(n, 3, replace=False)]
    m.pg_upmap[(2, 5)] = [int(v) for v in rng.choice(n, 5, replace=False)]
    for pool, ps in ((1, 7), (1, 11), (2, 2), (2, 9)):
        frm, to = (int(v) for v in rng.choice(n, 2, replace=False))
        m.pg_upmap_items[(pool, ps)] = [(frm, to)]
    m.pg_temp[(1, 4)] = [int(v) for v in rng.choice(n, 3, replace=False)]
    m.primary_temp[(1, 4)] = m.pg_temp[(1, 4)][1]
    m.pg_temp[(2, 6)] = [int(v) for v in rng.choice(n, 5, replace=False)]
    return m


def carried(m):
    return convert.osdmap_from_state(convert.osdmap_state(m))


@pytest.mark.parametrize("pool_id", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_pg_to_up_acting_osds_equals_reference(pool_id, seed):
    ref = exceptions(make_osdmap(seed), seed)
    port = carried(ref)
    for ps in range(ref.pools[pool_id].pg_num):
        assert port.pg_to_up_acting_osds(pool_id, ps) == \
            ref.pg_to_up_acting_osds(pool_id, ps), ps


@pytest.mark.parametrize("pool_id", [1, 2])
def test_map_pgs_batch_equals_reference_scalar_pipeline(pool_id):
    """Every batched row equals the reference's per-PG up set (holes kept
    for the EC pool, compacted for the replicated one)."""
    ref = exceptions(make_osdmap(2), 2)
    up_b, prim_b = carried(ref).map_pgs_batch(pool_id)
    size = ref.pools[pool_id].size
    for ps in range(ref.pools[pool_id].pg_num):
        up, upp, _, _ = ref.pg_to_up_acting_osds(pool_id, ps)
        row = np.full(size, ITEM_NONE, dtype=np.int64)
        row[:len(up)] = up
        assert list(up_b[ps]) == list(row), ps
        assert prim_b[ps] == upp, ps


def test_map_pgs_batch_equals_reference_map_pgs_batch():
    """The reference's own batched path (its jitted mapper), with upmaps
    and primary affinity on the replicated pool."""
    ref = exceptions(make_osdmap(3), 3)
    want_up, want_prim = ref.map_pgs_batch(1)
    got_up, got_prim = carried(ref).map_pgs_batch(1)
    assert got_up.dtype == np.int32 and got_prim.dtype == np.int32
    assert np.array_equal(got_up, np.asarray(want_up))
    assert np.array_equal(got_prim, np.asarray(want_prim))


def test_remap_after_mark_out_and_pps_batch():
    ref = make_osdmap(4)
    port = carried(ref)
    before, _ = port.map_pgs_batch(2)
    for m in (ref, port):
        m.mark_out(5)
        m.mark_down(9)
    after, _ = port.map_pgs_batch(2)
    assert port.epoch == ref.epoch
    assert (after != before).any()
    assert not (after == 5).any() and not (after == 9).any()
    pool = port.pools[2]
    pss = np.arange(1000)
    assert np.array_equal(pool.raw_pg_to_pps_batch(pss),
                          ref.pools[2].raw_pg_to_pps_batch(pss))
    for ps in range(pool.pg_num):
        up, upp, _, _ = ref.pg_to_up_acting_osds(2, ps)
        assert [o for o in after[ps]] == up


def test_osdmap_state_round_trip():
    ref = exceptions(make_osdmap(5), 5)
    ref.flags.add("noout")
    port = carried(ref)
    assert isinstance(port, port_osdmap.OSDMap)
    st = convert.osdmap_state(port)
    want = convert.osdmap_state(ref)
    for key in ("osd_exists", "osd_up", "osd_weight",
                "osd_primary_affinity"):
        assert np.array_equal(st[key], want[key])
    for key in ("pools", "flags", "pg_temp", "primary_temp", "pg_upmap",
                "pg_upmap_items", "epoch", "max_osd", "pool_id_max"):
        assert st[key] == want[key], key
