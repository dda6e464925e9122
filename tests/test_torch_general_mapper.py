"""The port's general per-lane CRUSH mapper against ceph_tpu's.

Every case runs the port's ``XlaMapper`` with the fast mapper switched
off (``fast=False``), so straw2 maps take the general trace too, and holds
it to the reference's scalar mapper (``scalar_mapper.do_rule``, the oracle
the reference's own ``tests/test_xla_mapper.py`` and
``tests/test_legacy_algs.py`` use) with exact equality, ITEM_NONE padding
included.  Maps are built in the reference package and carried across
with ``ceph_tpu_torch.convert``.  Two cases run the reference's own
general ``XlaMapper`` (``fast=False``; its jit compile is the costly part
of this file): the rack-then-host rule and the mixed-algorithm map.
Mirrors tests/test_xla_mapper.py and tests/test_legacy_algs.py.
"""
import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.placement import scalar_mapper as ref_scalar
from ceph_tpu.placement.builder import (TYPE_HOST, TYPE_OSD, TYPE_RACK,
                                        build_flat_cluster)
from ceph_tpu.placement.crush_map import (
    BUCKET_LIST, BUCKET_STRAW, BUCKET_STRAW2, BUCKET_TREE, BUCKET_UNIFORM,
    ITEM_NONE, RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP,
    RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP, RULE_EMIT,
    RULE_SET_CHOOSE_LOCAL_TRIES, RULE_SET_CHOOSELEAF_STABLE,
    RULE_SET_CHOOSELEAF_VARY_R, RULE_TAKE, Bucket, ChooseArg, CrushMap,
    Rule, Tunables, WEIGHT_ONE)
from ceph_tpu_torch import convert
from ceph_tpu_torch.common.options import config
from ceph_tpu_torch.common.perf_counters import perf
from ceph_tpu_torch.placement import xla_mapper as port_xla

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

TYPE_ROOT = 10
XS = np.concatenate([np.arange(129),
                     np.asarray([2**31 - 1, 2**31, 2**32 - 1, 12345678])])


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


def carried(cmap):
    return convert.crush_map_from_state(convert.crush_map_state(cmap))


def scalar_rows(cmap, ruleno, xs, result_max, weights, choose_args=None):
    out = np.full((len(xs), result_max), ITEM_NONE, dtype=np.int32)
    for i, x in enumerate(xs):
        got = ref_scalar.do_rule(cmap, ruleno, int(x), result_max,
                                 list(weights), choose_args)
        out[i, :len(got)] = got
    return out


def general(cmap, choose_args_key=None):
    return port_xla.XlaMapper(carried(cmap), choose_args_key=choose_args_key,
                              fast=False)


def check_general(cmap, ruleno, result_max, weights=None, xs=XS,
                  choose_args_key=None):
    """Port general trace == the reference's scalar mapper, every lane."""
    weights = weights or [WEIGHT_ONE] * cmap.max_devices
    args = cmap.choose_args.get(choose_args_key) \
        if choose_args_key is not None else None
    got = general(cmap, choose_args_key).map_batch(ruleno, xs, result_max,
                                                   weights)
    want = scalar_rows(cmap, ruleno, xs, result_max, weights, args)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    return got


def one_rule(cmap, steps):
    cmap.add_rule(Rule(steps=steps))
    return cmap


def jittered(n, seed):
    """Zero (out), partial and full 16.16 weights."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        roll = rng.random()
        out.append(0 if roll < 0.2 else
                   int(WEIGHT_ONE * rng.random()) if roll < 0.5 else
                   WEIGHT_ONE)
    return out


def weight_set_args(cmap, positions, seed):
    rng = np.random.default_rng(seed)
    return [None if b is None else ChooseArg(ids=None, weight_set=[
        [max(1, int(w * (0.5 + rng.random()))) for w in b.weights]
        for _ in range(positions)]) for b in cmap.buckets]


# ------------------------------------- tests/test_xla_mapper.py's cases --

def _xla_mapper_case(case):
    """-> (cmap, result_max, weights, xs, choose_args_key)."""
    cl = RULE_CHOOSELEAF_FIRSTN
    w = xs = key = None
    if case == "chooseleaf_firstn_replicated":
        cmap, root = build_flat_cluster(n_hosts=6, osds_per_host=4)
        one_rule(cmap, [(RULE_TAKE, root, 0), (cl, 0, TYPE_HOST),
                        (RULE_EMIT, 0, 0)])
        rm = 3
    elif case == "choose_firstn_direct_osd":
        cmap, root = build_flat_cluster(n_hosts=4, osds_per_host=6)
        one_rule(cmap, [(RULE_TAKE, root, 0),
                        (RULE_CHOOSE_FIRSTN, 0, TYPE_OSD),
                        (RULE_EMIT, 0, 0)])
        rm = 3
    elif case == "chooseleaf_indep_erasure":
        cmap, root = build_flat_cluster(n_hosts=8, osds_per_host=3)
        one_rule(cmap, [(RULE_TAKE, root, 0),
                        (RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST),
                        (RULE_EMIT, 0, 0)])
        rm = 6
    elif case == "choose_indep_direct_osd":
        cmap, root = build_flat_cluster(n_hosts=5, osds_per_host=5)
        one_rule(cmap, [(RULE_TAKE, root, 0),
                        (RULE_CHOOSE_INDEP, 4, TYPE_OSD), (RULE_EMIT, 0, 0)])
        rm = 4
    elif case == "two_step_rack_then_host":
        cmap, root = build_flat_cluster(n_racks=3, n_hosts=9,
                                        osds_per_host=3)
        one_rule(cmap, [(RULE_TAKE, root, 0),
                        (RULE_CHOOSE_FIRSTN, 2, TYPE_RACK),
                        (cl, 2, TYPE_HOST), (RULE_EMIT, 0, 0)])
        rm = 4
    elif case == "out_devices_reweight":
        cmap, root = build_flat_cluster(n_hosts=6, osds_per_host=4, seed=3)
        one_rule(cmap, [(RULE_TAKE, root, 0), (cl, 0, TYPE_HOST),
                        (RULE_EMIT, 0, 0)])
        rm, w = 3, jittered(cmap.max_devices, 7)
    elif case == "all_devices_out":
        cmap, root = build_flat_cluster(n_hosts=3, osds_per_host=2)
        one_rule(cmap, [(RULE_TAKE, root, 0), (cl, 0, TYPE_HOST),
                        (RULE_EMIT, 0, 0)])
        rm, w, xs = 3, [0] * cmap.max_devices, XS[:24]
    elif case == "more_replicas_than_hosts":
        cmap, root = build_flat_cluster(n_hosts=3, osds_per_host=4)
        one_rule(cmap, [(RULE_TAKE, root, 0), (cl, 0, TYPE_HOST),
                        (RULE_EMIT, 0, 0)])
        rm, xs = 5, XS[:32]
    elif case == "vary_r_and_stable_steps":
        cmap, root = build_flat_cluster(n_hosts=6, osds_per_host=4, seed=11)
        one_rule(cmap, [(RULE_SET_CHOOSELEAF_VARY_R, 0, 0),
                        (RULE_SET_CHOOSELEAF_STABLE, 0, 0),
                        (RULE_TAKE, root, 0), (cl, 0, TYPE_HOST),
                        (RULE_EMIT, 0, 0)])
        rm = 3
    elif case == "firefly_tunables":
        cmap, root = build_flat_cluster(
            n_hosts=6, osds_per_host=4, seed=5,
            tunables=Tunables.profile("firefly"))
        one_rule(cmap, [(RULE_TAKE, root, 0), (cl, 0, TYPE_HOST),
                        (RULE_EMIT, 0, 0)])
        rm = 3
    elif case == "multiple_takes_multiple_emits":
        cmap, root = build_flat_cluster(n_hosts=4, osds_per_host=3, seed=13)
        one_rule(cmap, [(RULE_TAKE, -1, 0),
                        (RULE_CHOOSE_FIRSTN, 1, TYPE_OSD), (RULE_EMIT, 0, 0),
                        (RULE_TAKE, root, 0), (cl, 2, TYPE_HOST),
                        (RULE_EMIT, 0, 0)])
        rm = 3
    elif case == "choose_args_weight_set":
        cmap, root = build_flat_cluster(n_hosts=4, osds_per_host=4, seed=17)
        cmap.choose_args["pool1"] = weight_set_args(cmap, 2, 23)
        one_rule(cmap, [(RULE_TAKE, root, 0), (cl, 0, TYPE_HOST),
                        (RULE_EMIT, 0, 0)])
        rm, key = 3, "pool1"
    elif case == "choose_args_weight_set_indep":
        # the top-level descent uses position outpos (0), the leaf rep
        cmap, root = build_flat_cluster(n_hosts=6, osds_per_host=4, seed=29)
        cmap.choose_args["ecpool"] = weight_set_args(cmap, 4, 31)
        one_rule(cmap, [(RULE_TAKE, root, 0),
                        (RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST),
                        (RULE_EMIT, 0, 0)])
        rm, key = 4, "ecpool"
    else:   # "rule_local_tries_step" below; the rest are separate tests
        raise AssertionError(case)
    return cmap, rm, w, XS if xs is None else xs, key


@pytest.mark.parametrize("case", [
    "chooseleaf_firstn_replicated", "choose_firstn_direct_osd",
    "chooseleaf_indep_erasure", "choose_indep_direct_osd",
    "two_step_rack_then_host", "out_devices_reweight", "all_devices_out",
    "more_replicas_than_hosts", "vary_r_and_stable_steps",
    "firefly_tunables", "multiple_takes_multiple_emits",
    "choose_args_weight_set", "choose_args_weight_set_indep",
])
def test_general_trace_equals_scalar(case):
    cmap, rm, w, xs, key = _xla_mapper_case(case)
    got = check_general(cmap, 0, rm, w, xs, choose_args_key=key)
    if case == "all_devices_out":
        assert (got == ITEM_NONE).all()
    if case == "more_replicas_than_hosts":
        assert (got[:, 3:] == ITEM_NONE).all()


def test_general_argonaut_tunables_raise():
    """Legacy local-retry tunables stay outside the batched mapper, in
    the map (compile_map) and in a rule step (the trace)."""
    m2, _ = build_flat_cluster(tunables=Tunables.profile("argonaut"))
    with pytest.raises(port_xla.UnsupportedMapError):
        port_xla.XlaMapper(carried(m2), fast=False)
    cmap, root = build_flat_cluster(n_hosts=4, osds_per_host=2)
    one_rule(cmap, [(RULE_SET_CHOOSE_LOCAL_TRIES, 2, 0),
                    (RULE_TAKE, root, 0),
                    (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                    (RULE_EMIT, 0, 0)])
    with pytest.raises(port_xla.UnsupportedMapError, match="local_tries"):
        general(cmap).map_batch(0, XS[:4], 3, [WEIGHT_ONE] * 8)


def test_general_large_batch_in_chunks(monkeypatch):
    """10,000 lanes through chunks of 4,096 (mapper_max_lanes_per_call):
    one result per lane, no hole, every lane on the general trace."""
    cmap, root = build_flat_cluster(n_hosts=6, osds_per_host=4)
    one_rule(cmap, [(RULE_TAKE, root, 0),
                    (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                    (RULE_EMIT, 0, 0)])
    weights = [WEIGHT_ONE] * cmap.max_devices
    config().set("mapper_max_lanes_per_call", 4096)
    try:
        mapper = general(cmap)
        monkeypatch.setattr(mapper, "_exact_rows", None)
        before = perf("crush.mapper").dump().get("general_map_s", {})
        xs = np.arange(10000)
        out = mapper.map_batch(0, xs, 3, weights)
    finally:
        config().clear("mapper_max_lanes_per_call")
    assert out.shape == (10000, 3) and out.dtype == np.int32
    assert np.all(out != ITEM_NONE)
    assert perf("crush.mapper").dump()["general_map_s"] != before
    sample = np.arange(0, 10000, 97)
    assert np.array_equal(out[sample], scalar_rows(cmap, 0, sample, 3,
                                                   weights))


def test_general_builder_mutations_still_map():
    """builder.c mutation roles (remove / reweight / move) and the text
    compiler round trip: the mutated map maps equal to the scalar
    mapper, and no placement uses the removed device."""
    from ceph_tpu.placement.builder import (find_parent, move_bucket,
                                            remove_item, reweight_item,
                                            reweight_subtree)
    from ceph_tpu.placement.compiler import (compile_crushmap,
                                             decompile_crushmap)
    cmap, root = build_flat_cluster(n_hosts=4, osds_per_host=3)
    one_rule(cmap, [(RULE_TAKE, root, 0),
                    (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                    (RULE_EMIT, 0, 0)])
    remove_item(cmap, 5)
    reweight_item(cmap, 0, 3 * WEIGHT_ONE)
    reweight_subtree(cmap, find_parent(cmap, 3), 2 * WEIGHT_ONE)
    move_bucket(cmap, find_parent(cmap, 9), find_parent(cmap, 3))
    back = compile_crushmap(decompile_crushmap(cmap))
    got = check_general(back, 0, 3, [WEIGHT_ONE] * back.max_devices)
    assert not (got == 5).any()


# ----------------------------------- tests/test_legacy_algs.py's cases --

ALGS = [(BUCKET_UNIFORM, "uniform"), (BUCKET_LIST, "list"),
        (BUCKET_TREE, "tree"), (BUCKET_STRAW, "straw")]


def build_alg_map(alg, n_hosts=5, osds_per_host=4, seed=0):
    """Hosts of the given algorithm under a straw2 root."""
    rng = np.random.default_rng(seed)
    m = CrushMap(tunables=Tunables.profile("jewel"))
    host_ids, host_weights = [], []
    dev = 0
    for h in range(n_hosts):
        items = list(range(dev, dev + osds_per_host))
        dev += osds_per_host
        if alg == BUCKET_UNIFORM:
            weights, bucket_w = [WEIGHT_ONE], WEIGHT_ONE * osds_per_host
        else:
            weights = [int(WEIGHT_ONE * (0.5 + rng.random())) for _ in items]
            bucket_w = sum(weights)
        m.add_bucket(Bucket(id=-(h + 1), alg=alg, type=TYPE_HOST,
                            items=items, weights=weights))
        host_ids.append(-(h + 1))
        host_weights.append(bucket_w)
    root = -(n_hosts + 1)
    m.add_bucket(Bucket(id=root, alg=BUCKET_STRAW2, type=TYPE_ROOT,
                        items=host_ids, weights=host_weights))
    m.finalize()
    return m, root


def mixed_alg_map():
    """Every algorithm at once: hosts alternate algs under one root."""
    rng = np.random.default_rng(7)
    m = CrushMap(tunables=Tunables.profile("jewel"))
    algs = [BUCKET_UNIFORM, BUCKET_LIST, BUCKET_TREE, BUCKET_STRAW,
            BUCKET_STRAW2, BUCKET_LIST]
    host_ids, host_w = [], []
    dev = 0
    for h, alg in enumerate(algs):
        items = list(range(dev, dev + 3))
        dev += 3
        if alg == BUCKET_UNIFORM:
            w, bw = [WEIGHT_ONE], 3 * WEIGHT_ONE
        else:
            w = [int(WEIGHT_ONE * (0.5 + rng.random())) for _ in items]
            bw = sum(w)
        m.add_bucket(Bucket(id=-(h + 1), alg=alg, type=TYPE_HOST,
                            items=items, weights=w))
        host_ids.append(-(h + 1))
        host_w.append(bw)
    m.add_bucket(Bucket(id=-7, alg=BUCKET_STRAW2, type=TYPE_ROOT,
                        items=host_ids, weights=host_w))
    m.finalize()
    m.add_rule(Rule(steps=[(RULE_TAKE, -7, 0),
                           (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                           (RULE_EMIT, 0, 0)]))
    m.add_rule(Rule(steps=[(RULE_TAKE, -7, 0),
                           (RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST),
                           (RULE_EMIT, 0, 0)]))
    return m


@pytest.mark.parametrize("alg,name", ALGS, ids=[n for _, n in ALGS])
def test_general_chooseleaf_firstn_over_legacy_hosts(alg, name):
    cmap, root = build_alg_map(alg)
    one_rule(cmap, [(RULE_TAKE, root, 0),
                    (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                    (RULE_EMIT, 0, 0)])
    check_general(cmap, 0, 3, xs=np.arange(192))


@pytest.mark.parametrize("alg,name", ALGS, ids=[n for _, n in ALGS])
def test_general_choose_indep_direct_legacy_root(alg, name):
    """A single legacy bucket as the choose target root."""
    rng = np.random.default_rng(3)
    m = CrushMap(tunables=Tunables.profile("jewel"))
    n = 9
    weights = [WEIGHT_ONE] if alg == BUCKET_UNIFORM else \
        [int(WEIGHT_ONE * (0.5 + rng.random())) for _ in range(n)]
    m.add_bucket(Bucket(id=-1, alg=alg, type=TYPE_ROOT,
                        items=list(range(n)), weights=weights))
    m.finalize()
    one_rule(m, [(RULE_TAKE, -1, 0), (RULE_CHOOSE_INDEP, 4, TYPE_OSD),
                 (RULE_EMIT, 0, 0)])
    check_general(m, 0, 4, xs=np.arange(160))


def test_general_every_algorithm_in_one_hierarchy():
    m = mixed_alg_map()
    check_general(m, 0, 3, xs=np.arange(160))
    check_general(m, 1, 4, xs=np.arange(160))


def test_general_uniform_permutation_deep():
    """numrep deep into the permutation (r up to about the size)."""
    m = CrushMap(tunables=Tunables.profile("jewel"))
    m.add_bucket(Bucket(id=-1, alg=BUCKET_UNIFORM, type=TYPE_ROOT,
                        items=list(range(7)), weights=[WEIGHT_ONE]))
    m.finalize()
    one_rule(m, [(RULE_TAKE, -1, 0), (RULE_CHOOSE_FIRSTN, 0, TYPE_OSD),
                 (RULE_EMIT, 0, 0)])
    check_general(m, 0, 6, xs=np.arange(256))


def test_general_dispatch_takes_the_refused_rules():
    """With the fast mapper on, a legacy map is refused by it (the rule
    key is remembered and counted) and maps on the general trace; no
    lane goes to the host."""
    cmap, root = build_alg_map(BUCKET_LIST)
    one_rule(cmap, [(RULE_TAKE, root, 0),
                    (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                    (RULE_EMIT, 0, 0)])
    weights = [WEIGHT_ONE] * cmap.max_devices
    mapper = port_xla.XlaMapper(carried(cmap), fast=True)
    pc = perf("crush.mapper")
    d0 = pc.dump()
    for _ in range(2):
        got = mapper.map_batch(0, np.arange(128), 3, weights)
        assert np.array_equal(got, scalar_rows(cmap, 0, np.arange(128), 3,
                                               weights))
    d1 = pc.dump()
    assert mapper._fast_unsupported == {(0, 3)}
    assert d1["fast_unsupported_rules"] == \
        d0.get("fast_unsupported_rules", 0) + 1
    assert d1.get("fallback_lanes", 0) == d0.get("fallback_lanes", 0)


def test_general_choose_args_reach_straw2_only():
    """choose_args weight sets apply ONLY to straw2 selection
    (mapper.c:309-326); legacy buckets keep native weights."""
    cmap, root = build_alg_map(BUCKET_LIST, n_hosts=4, osds_per_host=3)
    rng = np.random.default_rng(5)
    cmap.choose_args["p"] = [None if b is None else ChooseArg(
        ids=None, weight_set=[[max(1, int(w * (0.5 + rng.random())))
                               for w in b.weights]]) for b in cmap.buckets]
    one_rule(cmap, [(RULE_TAKE, root, 0),
                    (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                    (RULE_EMIT, 0, 0)])
    check_general(cmap, 0, 3, xs=np.arange(128), choose_args_key="p")


# ----------------------------------- the reference's own general trace --

def test_general_rack_then_host_equals_reference_trace():
    from ceph_tpu.placement.xla_mapper import XlaMapper as RefXlaMapper
    cmap, rm, w, _, _ = _xla_mapper_case("two_step_rack_then_host")
    xs = XS[:64]
    weights = jittered(cmap.max_devices, 41)
    want = np.asarray(RefXlaMapper(cmap, fast=False).map_batch(
        0, xs, rm, weights))
    got = general(cmap).map_batch(0, xs, rm, weights)
    assert np.array_equal(got, want.astype(np.int32))


def test_general_mixed_algorithms_equal_reference_trace():
    from ceph_tpu.placement.xla_mapper import XlaMapper as RefXlaMapper
    m = mixed_alg_map()
    xs = np.arange(64)
    weights = jittered(m.max_devices, 43)
    want = np.asarray(RefXlaMapper(m, fast=False).map_batch(0, xs, 2,
                                                             weights))
    got = general(m).map_batch(0, xs, 2, weights)
    assert np.array_equal(got, want.astype(np.int32))


# ------------------------------------------------- bucket primitives ----

def flat_map(alg, weights, n=None):
    m = CrushMap(tunables=Tunables.profile("jewel"))
    n = len(weights) if n is None else n
    m.add_bucket(Bucket(id=-1, alg=alg, type=TYPE_ROOT,
                        items=list(range(n)), weights=weights))
    m.finalize()
    one_rule(m, [(RULE_TAKE, -1, 0), (RULE_CHOOSE_FIRSTN, 0, TYPE_OSD),
                 (RULE_EMIT, 0, 0)])
    one_rule(m, [(RULE_TAKE, -1, 0), (RULE_CHOOSE_INDEP, 0, TYPE_OSD),
                 (RULE_EMIT, 0, 0)])
    return m


def test_tree_node_weights_past_2_31():
    """The 32.32 tree draw is u64 in the reference: 48 items of weight
    2^26 put the root node at 3 x 2^31, where hash * weight overflows a
    signed 64-bit product; the split weight keeps it exact."""
    m = flat_map(BUCKET_TREE, [1 << 26] * 47 + [3 << 24])
    root = m.buckets[0]
    assert max(root.node_weights) >= 1 << 31
    for ruleno in (0, 1):
        check_general(m, ruleno, 4, xs=np.arange(200))


def test_list_prefix_sums_past_2_31():
    m = flat_map(BUCKET_LIST, [1 << 26] * 40 + [5 << 25] * 8)
    assert max(m.buckets[0].sum_weights) >= 1 << 31
    for ruleno in (0, 1):
        check_general(m, ruleno, 4, xs=np.arange(100))


def test_uniform_r_at_or_past_the_size():
    """r >= n wraps to r % n in the permutation; out devices force the
    retries that carry r past the bucket's size."""
    m = flat_map(BUCKET_UNIFORM, [WEIGHT_ONE], n=3)
    weights = [0, WEIGHT_ONE, WEIGHT_ONE // 3]
    for ruleno in (0, 1):
        got = check_general(m, ruleno, 3, weights, xs=np.arange(96))
        assert (got == 0).sum() == 0


def test_straw_v1_ties_break_on_the_first_item():
    """Equal straws and equal hashes tie: the scalar scan keeps the first
    item, and so must torch.argmax."""
    m = flat_map(BUCKET_STRAW, [WEIGHT_ONE] * 5)
    check_general(m, 0, 2, xs=np.arange(300))


def test_indep_uniform_retry_schedule_follows_the_c_mapper():
    """crush_choose_indep adds (numrep + 1) * ftotal to r, not numrep *
    ftotal, while it walks a uniform bucket whose size numrep divides
    (mapper.c:692-698; scalar_mapper.choose_indep and the native mapper
    do).  The reference's general XlaMapper leaves the case out (ROADMAP
    section C); the port follows the C mapper.  Smallest input: one
    uniform bucket of 4 OSDs, osd.0 out, choose indep 2 type osd, x = 2:
    [3, 1] here and in the scalar mapper."""
    m = CrushMap(tunables=Tunables.profile("jewel"))
    m.add_bucket(Bucket(id=-1, alg=BUCKET_UNIFORM, type=TYPE_ROOT,
                        items=[0, 1, 2, 3], weights=[WEIGHT_ONE]))
    m.finalize()
    one_rule(m, [(RULE_TAKE, -1, 0), (RULE_CHOOSE_INDEP, 2, TYPE_OSD),
                 (RULE_EMIT, 0, 0)])
    weights = [0, WEIGHT_ONE, WEIGHT_ONE, WEIGHT_ONE]
    got = check_general(m, 0, 2, weights, xs=np.arange(32))
    assert list(got[2]) == [3, 1]
    # and through a uniform host under a chained indep step
    hosts = CrushMap(tunables=Tunables.profile("jewel"))
    for h in range(4):
        hosts.add_bucket(Bucket(id=-(h + 1), alg=BUCKET_UNIFORM,
                                type=TYPE_HOST,
                                items=list(range(4 * h, 4 * h + 4)),
                                weights=[WEIGHT_ONE]))
    hosts.add_bucket(Bucket(id=-5, alg=BUCKET_STRAW2, type=TYPE_ROOT,
                            items=[-1, -2, -3, -4],
                            weights=[4 * WEIGHT_ONE] * 4))
    hosts.finalize()
    one_rule(hosts, [(RULE_TAKE, -5, 0), (RULE_CHOOSE_INDEP, 2, TYPE_HOST),
                     (RULE_CHOOSE_INDEP, 2, TYPE_OSD), (RULE_EMIT, 0, 0)])
    one_rule(hosts, [(RULE_TAKE, -5, 0),
                     (RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST),
                     (RULE_EMIT, 0, 0)])
    w16 = [0 if i % 4 == 1 else WEIGHT_ONE for i in range(16)]
    check_general(hosts, 0, 4, w16, xs=np.arange(64))
    check_general(hosts, 1, 4, w16, xs=np.arange(64))


def test_profile_script_rehearses_on_the_cpu(monkeypatch, capsys):
    """placement_profile.py maps chip_smoke's straw cluster three times
    (the sweeps must agree) and prints one JSON line; on the CPU it
    reports no device number."""
    import json
    import sys
    import placement_profile
    monkeypatch.setattr(sys, "argv", ["placement_profile.py", "--cpu",
                                      "--pgs", "256"])
    assert placement_profile.main() == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["pool"] == "ec42" and out["pgs"] == 256
    assert out["device_ms"] is None and out["aten_ops"] > 0
