"""The port's batched CRUSH mapper against ceph_tpu's.

Maps are built in the reference package and carried across with
``ceph_tpu_torch.convert`` (so the carry itself is under test); the same
x values and weights go through both.  CRUSH has no tolerance: every
comparison is exact, on the CPU.  Two cases run the reference's own
``XlaMapper.map_batch`` (its jit compile is the costly part of this
file); the rest hold the port to the reference's scalar mapper, the
oracle the reference's own fast-mapper tests use, and to the golden
crush_do_rule vectors of tests/golden/crush_vectors.json.  Mirrors
tests/test_fast_mapper.py and tests/test_xla_mapper.py.
"""
import json
import os

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.placement import scalar_mapper as ref_scalar
from ceph_tpu.placement.builder import (TYPE_HOST, TYPE_OSD, TYPE_RACK,
                                        build_flat_cluster)
from ceph_tpu.placement.crush_map import (
    BUCKET_LIST, ITEM_NONE, RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP,
    RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP, RULE_EMIT,
    RULE_SET_CHOOSE_TRIES, RULE_SET_CHOOSELEAF_STABLE,
    RULE_SET_CHOOSELEAF_VARY_R, RULE_TAKE, Bucket, ChooseArg, CrushMap,
    Rule, WEIGHT_ONE)
from ceph_tpu_torch import convert
from ceph_tpu_torch.placement import xla_mapper as port_xla
from ceph_tpu_torch.placement.crush_map import CrushMap as PortCrushMap

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "crush_vectors.json")
XS = np.arange(384)
XS_BIG = np.concatenate([np.arange(128),
                         np.asarray([2**31 - 1, 2**31, 2**32 - 1])])


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


def check_port(cmap, ruleno, result_max, weights, xs=XS,
               choose_args_key=None):
    """Port XlaMapper (fast mapper + exact host recompute) == the
    reference's scalar mapper on every lane."""
    args = cmap.choose_args.get(choose_args_key) \
        if choose_args_key is not None else None
    got = port_xla.XlaMapper(carried(cmap),
                             choose_args_key=choose_args_key) \
        .map_batch(ruleno, xs, result_max, weights)
    want = scalar_rows(cmap, ruleno, xs, result_max, weights, args)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    return got


def flat(rule_op, numrep=0, target=TYPE_HOST, **kw):
    cmap, root = build_flat_cluster(**kw)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0), (rule_op, numrep, target),
                              (RULE_EMIT, 0, 0)]))
    return cmap


def mixed_weights(n, seed):
    """Zero (out), partial and full 16.16 weights."""
    rng = np.random.default_rng(seed)
    roll = rng.random(n)
    w = np.where(roll < 0.15, 0,
                 np.where(roll < 0.4, (WEIGHT_ONE * rng.random(n)).astype(int),
                          WEIGHT_ONE))
    return [int(v) for v in w]


# ------------------------------------------------- against the reference --

def test_map_batch_equals_reference_map_batch():
    """The reference's own XlaMapper.map_batch (its jit compile is the
    costly part of this file, so one tight case): 3 rows over 3 hosts
    with out and partial weights, where many lanes exhaust the
    candidate grid and are recomputed exactly on the host."""
    from ceph_tpu.placement.xla_mapper import XlaMapper as RefXlaMapper
    cmap = flat(RULE_CHOOSELEAF_FIRSTN, n_hosts=3, osds_per_host=4, seed=3)
    weights = mixed_weights(cmap.max_devices, seed=11)
    xs = XS[:256]
    ref = RefXlaMapper(cmap)
    want = np.asarray(ref.map_batch(0, xs, 3, weights))
    port = port_xla.XlaMapper(carried(cmap))
    got = port.map_batch(0, xs, 3, weights)
    assert np.array_equal(got, want.astype(np.int32))
    # the lanes the port flags incomplete are a subset of the reference's
    _, ref_inc = ref._fast.map_batch(0, xs, 3, weights)
    _, port_inc = port._fast.map_batch(0, xs, 3, weights)
    ref_inc, port_inc = np.asarray(ref_inc), np.asarray(port_inc)
    assert port_inc.any()
    assert not (port_inc & ~ref_inc).any()


@pytest.mark.parametrize("case", [
    "firstn_chooseleaf", "firstn_direct_osd", "indep_chooseleaf",
    "indep_direct_osd", "mixed_weights_out", "large_x", "vary_r_stable_off",
    "multiple_takes_emits", "numrep_exceeds_domains", "indep_choose_tries",
    "indep_holes",
])
def test_map_batch_equals_reference_scalar(case):
    w1 = None
    xs = XS
    if case == "firstn_chooseleaf":
        cmap, rm = flat(RULE_CHOOSELEAF_FIRSTN, n_hosts=8,
                        osds_per_host=4), 3
    elif case == "firstn_direct_osd":
        cmap, rm = flat(RULE_CHOOSE_FIRSTN, target=TYPE_OSD, n_hosts=5,
                        osds_per_host=6), 3
    elif case == "indep_chooseleaf":
        cmap, rm = flat(RULE_CHOOSELEAF_INDEP, n_hosts=10,
                        osds_per_host=3), 6
    elif case == "indep_direct_osd":
        cmap, rm = flat(RULE_CHOOSE_INDEP, 4, TYPE_OSD, n_hosts=6,
                        osds_per_host=5), 4
    elif case == "mixed_weights_out":
        cmap, rm = flat(RULE_CHOOSELEAF_FIRSTN, n_hosts=8, osds_per_host=4,
                        seed=3), 3
        w1 = mixed_weights(cmap.max_devices, seed=5)
    elif case == "large_x":
        cmap, rm = flat(RULE_CHOOSELEAF_FIRSTN, n_hosts=6, osds_per_host=4,
                        seed=7), 3
        xs = XS_BIG
    elif case == "vary_r_stable_off":
        cmap, root = build_flat_cluster(n_hosts=6, osds_per_host=4, seed=13)
        cmap.add_rule(Rule(steps=[(RULE_SET_CHOOSELEAF_VARY_R, 1, 0),
                                  (RULE_SET_CHOOSELEAF_STABLE, 0, 0),
                                  (RULE_TAKE, root, 0),
                                  (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                                  (RULE_EMIT, 0, 0)]))
        rm = 3
    elif case == "multiple_takes_emits":
        cmap, root = build_flat_cluster(n_hosts=4, osds_per_host=3, seed=17)
        cmap.add_rule(Rule(steps=[(RULE_TAKE, -1, 0),
                                  (RULE_CHOOSE_FIRSTN, 1, TYPE_OSD),
                                  (RULE_EMIT, 0, 0),
                                  (RULE_TAKE, root, 0),
                                  (RULE_CHOOSELEAF_FIRSTN, 2, TYPE_HOST),
                                  (RULE_EMIT, 0, 0)]))
        rm = 3
    elif case == "numrep_exceeds_domains":   # the oracle retries: fewer x
        cmap, rm = flat(RULE_CHOOSELEAF_FIRSTN, n_hosts=3,
                        osds_per_host=4), 5
        xs = XS[:96]
    elif case == "indep_holes":     # 5 slots over 3 hosts: ITEM_NONE
        cmap, rm = flat(RULE_CHOOSELEAF_INDEP, n_hosts=3, osds_per_host=4,
                        seed=8), 5
        xs = XS[:96]
    else:   # a small set_choose_tries: no round the reference skips
        cmap, root = build_flat_cluster(n_hosts=8, osds_per_host=3, seed=47)
        cmap.add_rule(Rule(steps=[(RULE_SET_CHOOSE_TRIES, 4, 0),
                                  (RULE_TAKE, root, 0),
                                  (RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST),
                                  (RULE_EMIT, 0, 0)]))
        rm = 6
    weights = w1 or [WEIGHT_ONE] * cmap.max_devices
    got = check_port(cmap, 0, rm, weights, xs)
    if case == "indep_holes":
        assert (got == ITEM_NONE).any()


def test_choose_args_single_position_weight_set():
    cmap, root = build_flat_cluster(n_hosts=5, osds_per_host=4, seed=19)
    rng = np.random.default_rng(23)
    args = []
    for b in cmap.buckets:
        args.append(None if b is None else ChooseArg(
            ids=None, weight_set=[[max(1, int(w * (0.5 + rng.random())))
                                   for w in b.weights]]))
    cmap.choose_args["p"] = args
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    check_port(cmap, 0, 3, [WEIGHT_ONE] * cmap.max_devices, XS[:256],
               choose_args_key="p")


def test_forced_tie_breaks_on_the_first_item():
    """choose_args ids make two items hash alike and their weights are
    equal, so every draw ties: the scalar scan keeps the first item, and
    so must torch.argmin."""
    cmap, root = build_flat_cluster(n_hosts=4, osds_per_host=3)
    args = [None] * len(cmap.buckets)
    rootb = cmap.bucket(root)
    args[-1 - root] = ChooseArg(ids=[7] * rootb.size, weight_set=None)
    cmap.choose_args["tie"] = args
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSE_FIRSTN, 1, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    got = check_port(cmap, 0, 1, [WEIGHT_ONE] * cmap.max_devices, XS[:64],
                     choose_args_key="tie")
    assert (got[:, 0] == rootb.items[0]).all()


def test_map_batch_delta_after_weight_drop():
    cmap = flat(RULE_CHOOSELEAF_INDEP, n_hosts=8, osds_per_host=4, seed=5)
    before_w = [WEIGHT_ONE] * cmap.max_devices
    mapper = port_xla.XlaMapper(carried(cmap))
    before = mapper.map_batch(0, XS, 4, before_w)
    after_w = list(before_w)
    for d in (2, 9, 17):
        after_w[d] = 0
    after_w[21] = WEIGHT_ONE // 2
    delta = mapper.map_batch_delta(0, XS, 4, before_w, after_w, before)
    assert np.array_equal(delta, mapper.map_batch(0, XS, 4, after_w))
    assert np.array_equal(delta, scalar_rows(cmap, 0, XS, 4, after_w))
    assert not np.array_equal(delta, before)


def test_chained_choose_raises_naming_the_later_slice():
    """A chained rule (choose feeding chooseleaf) is outside the fast
    subset; it once raised, naming the later slice that would carry it.
    The general per-lane trace carries it now: it maps, equal to the
    reference's scalar mapper."""
    cmap, root = build_flat_cluster(n_racks=3, n_hosts=9, osds_per_host=3)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSE_FIRSTN, 2, TYPE_RACK),
                              (RULE_CHOOSELEAF_FIRSTN, 2, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    got = check_port(cmap, 0, 4, [WEIGHT_ONE] * cmap.max_devices, XS[:96])
    assert (got != ITEM_NONE).all()


def test_legacy_bucket_map_raises():
    """A list bucket is outside the fast subset; it once raised.  The
    general per-lane trace maps it now, equal to the scalar mapper."""
    cmap = CrushMap()
    cmap.add_bucket(Bucket(id=-1, alg=BUCKET_LIST, type=1,
                           items=[0, 1, 2, 3], weights=[WEIGHT_ONE] * 4))
    cmap.add_rule(Rule(steps=[(RULE_TAKE, -1, 0),
                              (RULE_CHOOSE_FIRSTN, 0, 0), (RULE_EMIT, 0, 0)]))
    cmap.finalize()
    got = check_port(cmap, 0, 2, [WEIGHT_ONE] * 4, XS[:64])
    assert (got != ITEM_NONE).all()


def test_crush_map_state_round_trip():
    cmap, root = build_flat_cluster(n_racks=2, n_hosts=6, osds_per_host=2,
                                    seed=9, weight_jitter=True)
    cmap.choose_args[1] = [None] * len(cmap.buckets)
    cmap.choose_args[1][0] = ChooseArg(ids=[-5, -6], weight_set=[[3, 4]])
    state = convert.crush_map_state(cmap)
    back = convert.crush_map_from_state(state)
    assert isinstance(back, PortCrushMap)
    assert back.to_spec() == cmap.to_spec()
    again = convert.crush_map_state(back)
    for a, b in zip(again["buckets"], state["buckets"]):
        assert a.keys() == b.keys()
        for key in a:
            assert (a[key] is None and b[key] is None) or \
                np.array_equal(a[key], b[key])
    assert back.choose_args[1][0].ids == [-5, -6]
    assert back.choose_args[1][0].weight_set == [[3, 4]]


# ----------------------------------------------------------- golden -----

@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        data = json.load(f)
    rng = np.random.RandomState(42)     # scripts/gen_golden.py's draws
    reweighted = {}
    for si, spec in enumerate(data["specs"]):
        reweighted[si] = [int(w) for w in
                          rng.randint(0, 0x10001, size=spec["num_devices"])]
        rng.randint(0, 2**31 - 1, size=64)
    groups = {}
    for case in data["cases"]:
        key = (case["map"], case["rule"], case["result_max"],
               case["weights"])
        groups.setdefault(key, []).append(case)
    return data, reweighted, groups


def _golden_weights(spec, name, reweighted):
    nd = spec["num_devices"]
    if name == "all_in":
        return [WEIGHT_ONE] * nd
    if name == "some_out":
        return [0 if i % 5 == 0 else WEIGHT_ONE for i in range(nd)]
    return reweighted


@pytest.mark.parametrize("map_index", range(10))
def test_golden_crush_vectors(golden, map_index):
    """Every (rule, result_max, weights) group of one golden map equals
    the reference C's crush_do_rule, legacy bucket algorithms and chained
    rules included.  The one map with the argonaut profile's local-retry
    tunables must raise UnsupportedMapError in both packages, never map
    quietly."""
    from ceph_tpu.placement.xla_mapper import UnsupportedMapError as RefErr
    from ceph_tpu.placement.xla_mapper import compile_map as ref_compile
    data, reweighted, groups = golden
    spec = data["specs"][map_index]
    if spec["tunables"].get("choose_local_tries"):
        assert spec["name"] == "two_level_argonaut"
        with pytest.raises(port_xla.UnsupportedMapError):
            port_xla.XlaMapper(PortCrushMap.from_spec(spec))
        with pytest.raises(RefErr):
            ref_compile(CrushMap.from_spec(spec))
        return
    mapper = port_xla.XlaMapper(PortCrushMap.from_spec(spec))
    mapped = 0
    for (mi, rule, rm, wname), cases in sorted(groups.items()):
        if mi != map_index:
            continue
        weights = _golden_weights(spec, wname, reweighted[mi])
        xs = np.asarray([c["x"] for c in cases], dtype=np.int64)
        got = mapper.map_batch(rule, xs, rm, weights)
        want = np.full((len(cases), rm), ITEM_NONE, dtype=np.int32)
        for i, c in enumerate(cases):
            want[i, :len(c["result"])] = c["result"]
        assert np.array_equal(got, want), (spec["name"], rule, rm, wname)
        mapped += 1
    assert mapped > 0
