"""The port's sharded data plane (parallel/data_plane.py) against
ceph_tpu's, on 8 CPU cells.

Twin of tests/test_data_plane.py and of the plane cases of
tests/test_ragged_fused.py.  The reference's plane runs over the 8 host
devices tests/conftest.py forces; the port's over 8 CPU cells
(``mesh.cells_per_device = 8``, the CPU asked for), where every cell runs
the kernels' plain versions.  Each case runs the same seeded inputs
through both planes, on the 1-D mesh and on the 2 x 4 mesh
(``parallel_data_plane_stripes = 2``; the dispatch-level cases also on
the 4 x 2 mesh), and holds the port to the
reference bit for bit, with no tolerance: the dispatch results, the
psum, the cluster step's bytes, recovery stats and up sets, the remap
sweep, the fused ragged encode, and the ``perf("dataplane")`` dump.
"""
import contextlib
import types

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.cluster import monitor as ref_monitor
from ceph_tpu.cluster import objecter as ref_objecter
from ceph_tpu.cluster import osdmap as ref_osdmap
from ceph_tpu.cluster import simulator as ref_simulator
from ceph_tpu.common import op_tracker as ref_op_tracker
from ceph_tpu.common import options as ref_options
from ceph_tpu.common import perf_counters as ref_perf
from ceph_tpu.ops import ragged_fused as ref_rf
from ceph_tpu.parallel import data_plane as ref_dp
from ceph_tpu.placement import builder as ref_builder
from ceph_tpu.placement import crush_map as ref_cm
from ceph_tpu_torch.cluster import monitor as port_monitor
from ceph_tpu_torch.cluster import objecter as port_objecter
from ceph_tpu_torch.cluster import osdmap as port_osdmap
from ceph_tpu_torch.cluster import simulator as port_simulator
from ceph_tpu_torch.common import op_tracker as port_op_tracker
from ceph_tpu_torch.common import options as port_options
from ceph_tpu_torch.common import perf_counters as port_perf
from ceph_tpu_torch.ops import gf, ragged_fused, xor_kernel
from ceph_tpu_torch.parallel import data_plane as port_dp
from ceph_tpu_torch.parallel import mesh
from ceph_tpu_torch.placement import builder as port_builder
from ceph_tpu_torch.placement import crush_map as port_cm

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

REF = types.SimpleNamespace(
    name="ref", opts=ref_options, perf=ref_perf.perf, dp=ref_dp,
    om=ref_osdmap, sim=ref_simulator, mon=ref_monitor, obj=ref_objecter,
    tracker=ref_op_tracker.tracker, builder=ref_builder, cm=ref_cm)
PORT = types.SimpleNamespace(
    name="port", opts=port_options, perf=port_perf.perf, dp=port_dp,
    om=port_osdmap, sim=port_simulator, mon=port_monitor, obj=port_objecter,
    tracker=port_op_tracker.tracker, builder=port_builder, cm=port_cm)

N_CELLS = 8
LAYOUTS = {"1d": 0, "2x4": 2}
# the dispatch-level cases also run on the 4 x 2 mesh
DISPATCH_LAYOUTS = {**LAYOUTS, "4x2": 4}


@pytest.fixture(autouse=True)
def cells8():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    mesh.cells_per_device = N_CELLS
    yield
    mesh.cells_per_device = 1
    ceph_tpu_torch.set_default_device(prev)
    for pkg in (REF, PORT):
        for opt in ("parallel_data_plane", "parallel_data_plane_devices",
                    "parallel_data_plane_stripes"):
            pkg.opts.config().clear(opt)


@contextlib.contextmanager
def plane_on(pkg, stripes=0, on=True):
    cfg = pkg.opts.config()
    cfg.set("parallel_data_plane", on)
    if stripes:
        cfg.set("parallel_data_plane_stripes", stripes)
    try:
        yield
    finally:
        cfg.clear("parallel_data_plane")
        cfg.clear("parallel_data_plane_stripes")


def dump(pkg):
    """The ``dataplane`` group's counters that moved."""
    return {k: v for k, v in pkg.perf("dataplane").dump().items() if v}


def reset():
    for pkg in (REF, PORT):
        pkg.perf("dataplane").reset()


# ----------------------------------------------------------- resolution --

def test_plane_off_by_default():
    for pkg in (REF, PORT):
        assert pkg.opts.config().get("parallel_data_plane") is False
        assert pkg.dp.plane() is None


def test_one_cell_per_device_leaves_the_plane_off():
    """One card, or the CPU at the default count of one cell, resolves
    one cell: the plane stays off with the option on, as the
    reference's does on one device."""
    mesh.cells_per_device = 1
    with plane_on(PORT):
        assert port_dp.enabled() and port_dp.plane() is None
        mesh.cells_per_device = 2
        assert port_dp.plane().n_shards == 2


def test_plane_respects_device_budget():
    got = {}
    for pkg in (REF, PORT):
        with plane_on(pkg):
            cfg = pkg.opts.config()
            cfg.set("parallel_data_plane_devices", 4)
            try:
                seen = [pkg.dp.plane().n_shards]
                cfg.set("parallel_data_plane_devices", 4096)
                seen.append(pkg.dp.plane())
                cfg.set("parallel_data_plane_stripes", 3)
                cfg.set("parallel_data_plane_devices", 0)
                seen.append(pkg.dp.plane())
                cfg.set("parallel_data_plane_stripes", 4)
                seen.append(pkg.dp.plane().mesh.devices.shape)
            finally:
                cfg.clear("parallel_data_plane_devices")
                cfg.clear("parallel_data_plane_stripes")
            seen.append(pkg.dp.plane().n_shards)
        got[pkg.name] = seen
    assert got["port"] == got["ref"] == [4, None, None, (4, 2), N_CELLS]


# ------------------------------------------------------------- dispatch --

def xor_inputs(seed, shapes):
    rng = np.random.default_rng(seed)
    out = []
    for B in shapes:
        masks = (rng.integers(0, 2, (24, 32), dtype=np.int64)
                 .astype(np.int32) * -1)
        words = rng.integers(-2**31, 2**31 - 1, (B, 32, 16),
                             dtype=np.int64).astype(np.int32)
        mb = (rng.integers(0, 2, (B, 24, 32), dtype=np.int64)
              .astype(np.int32) * -1)
        out.append((masks, words, mb))
    return out


@pytest.mark.parametrize("layout", list(DISPATCH_LAYOUTS))
def test_sharded_xor_bit_identical_to_kernel(layout):
    """The sharded dispatch equals the single-device kernel and the
    reference's plane bit for bit: replicated masks, per-batch masks,
    ragged batches and a lead-less operand; the psum and the dump are
    the reference's."""
    cases = xor_inputs(0, (1, 7, 8, 13))
    outs, psums = {}, {}
    reset()
    for pkg in (REF, PORT):
        with plane_on(pkg, DISPATCH_LAYOUTS[layout]):
            dp = pkg.dp.plane()
            assert dp.n_shards == N_CELLS and dp.is_2d == (layout != "1d")
            res = []
            for masks, words, mb in cases:
                res.append(np.asarray(dp.xor_matmul_w32(masks, words)))
                res.append(np.asarray(dp.xor_matmul_w32(
                    mb, words, kind="recover")))
            masks, words, _ = cases[-1]
            res.append(np.asarray(dp.xor_matmul_w32(masks, words[0],
                                                    kind="decode")))
            psums[pkg.name] = dp.psum_probe()
            res.append(np.asarray(dp.xor_matmul_w32(masks, words[:1])))
            psums[pkg.name] = (psums[pkg.name], dp.psum_probe())
        outs[pkg.name] = res
    want = []
    for masks, words, mb in cases:
        want.append(xor_kernel.xor_matmul_w32(masks, words).numpy())
        want.append(xor_kernel.xor_matmul_w32(mb, words).numpy())
    masks, words, _ = cases[-1]
    want.append(xor_kernel.xor_matmul_w32(masks, words[0]).numpy())
    want.append(xor_kernel.xor_matmul_w32(masks, words[:1]).numpy())
    for g, r, w in zip(outs["port"], outs["ref"], want):
        assert g.shape == r.shape == w.shape
        assert np.array_equal(g, r) and np.array_equal(g, w)
    # the psum reduced the padded batch: B=1 pads to the mesh size (1-D)
    # or to the stripe rows (2-D)
    pad = DISPATCH_LAYOUTS[layout] or N_CELLS
    assert psums["port"] == psums["ref"] == (pad, pad)
    assert dump(PORT) == dump(REF)


@pytest.mark.parametrize("layout", list(DISPATCH_LAYOUTS))
def test_rebuild_collective_bit_identical_and_ppermute(layout):
    """The collective rebuild equals the kernel and the reference's, for
    replicated and per-stripe masks at ragged batches; the ring rotates
    batch blocks one mesh position; landing accounting and the dump are
    the reference's."""
    rng = np.random.default_rng(5)
    cases = []
    for B in (1, 6, 8, 17):
        masks = (rng.integers(0, 2, (16, 24), dtype=np.int64)
                 .astype(np.int32) * -1)
        words = rng.integers(-2**31, 2**31 - 1, (B, 24, 8),
                             dtype=np.int64).astype(np.int32)
        mb = (rng.integers(0, 2, (B, 16, 24), dtype=np.int64)
              .astype(np.int32) * -1)
        cases.append((masks, words, mb))
    n = N_CELLS
    x = np.arange(2 * n * 4, dtype=np.int32).reshape(2 * n, 4)
    outs = {}
    reset()
    for pkg in (REF, PORT):
        with plane_on(pkg, DISPATCH_LAYOUTS[layout]):
            dp = pkg.dp.plane()
            res = []
            for masks, words, mb in cases:
                res.append(np.asarray(dp.rebuild_collective(masks, words)))
                res.append(np.asarray(dp.rebuild_collective(mb, words)))
            for shift in (1, 3, n + 2):
                res.append(np.asarray(dp.ppermute_shift(x, shift)))
            with pytest.raises(ValueError):
                dp.ppermute_shift(np.zeros((n + 1, 2), np.int32))
            dp.account_landed(3, 4, 128)
            dp.account_landed(12, 2, 64)
            res.append(dp.chip_of(3))
        outs[pkg.name] = res
    want = []
    for masks, words, mb in cases:
        want.append(xor_kernel.xor_matmul_w32(masks, words).numpy())
        want.append(xor_kernel.xor_matmul_w32(mb, words).numpy())
    for shift in (1, 3, n + 2):
        want.append(np.roll(x.reshape(n, 2, 4), shift, axis=0)
                    .reshape(2 * n, 4))
    want.append(3)
    for g, r, w in zip(outs["port"], outs["ref"], want):
        assert np.array_equal(g, r) and np.array_equal(g, w)
    d = dump(PORT)
    assert d == dump(REF)
    assert d["allgather_rows"] > 0 and d["ppermute_rows"] == 3 * 2 * n
    assert d["shard3.recover_landed_bytes"] == 512


# ----------------------------------------------------------- the system --

def _crush(pkg):
    """tests/test_simulator.py's map: 8 hosts x 3 OSDs, a replicated and
    an indep rule."""
    cm = pkg.cm
    cmap, root = pkg.builder.build_flat_cluster(n_hosts=8, osds_per_host=3,
                                                seed=0)
    cmap.add_rule(cm.Rule(steps=[(cm.RULE_TAKE, root, 0),
                                 (cm.RULE_CHOOSELEAF_FIRSTN, 0,
                                  pkg.builder.TYPE_HOST),
                                 (cm.RULE_EMIT, 0, 0)]))
    cmap.add_rule(cm.Rule(steps=[(cm.RULE_TAKE, root, 0),
                                 (cm.RULE_CHOOSELEAF_INDEP, 0,
                                  pkg.builder.TYPE_HOST),
                                 (cm.RULE_EMIT, 0, 0)]))
    return cmap


@pytest.fixture(scope="module")
def ref_mapper():
    """One reference XlaMapper for the map, shared by every reference
    sim of this file (weights are runtime operands and each mesh keys
    its own jit, so sharing changes no result; the compiles are the bulk
    of the reference's time)."""
    from ceph_tpu.placement.xla_mapper import XlaMapper
    cmap = _crush(REF)
    return cmap, XlaMapper(cmap)


def make_sim(pkg, ref_mapper):
    """tests/test_simulator.py's make_sim in ``pkg``."""
    om_mod = pkg.om
    if pkg is REF:
        cmap, mapper = ref_mapper
        om = om_mod.OSDMap(cmap)
        om._mapper, om._mapper_map = mapper, cmap
    else:
        om = om_mod.OSDMap(_crush(pkg), device="cpu")
    om.mark_all_in_up()
    om.add_pool(om_mod.PGPool(id=1, name="rep", type=om_mod.POOL_REPLICATED,
                              size=3, pg_num=32, crush_rule=0))
    om.add_pool(om_mod.PGPool(id=2, name="ec", type=om_mod.POOL_ERASURE,
                              size=6, pg_num=32, crush_rule=1,
                              erasure_code_profile="default"))
    sim = pkg.sim.ClusterSim(om)
    sim.create_ec_profile("default", {"plugin": "jax", "k": "4", "m": "2"})
    return sim


def drive_cluster(pkg, ref_mapper, shard, stripes=0, seed=7, n_objs=12):
    """put_many -> kill 2 up-set members -> degraded gets -> out ->
    recover_all -> remap sweep -> gets again; returns everything
    comparable."""
    with plane_on(pkg, stripes, on=shard):
        sim = make_sim(pkg, ref_mapper)
        rng = np.random.default_rng(seed)
        names = [f"o{i}" for i in range(n_objs)]
        datas = [rng.integers(0, 256, int(sz), dtype=np.uint8).tobytes()
                 for sz in rng.integers(500, 60000, n_objs)]
        placed = sim.put_many(2, names, datas)
        pool = sim.osdmap.pools[2]
        up = sim.pg_up(pool, sim.object_pg(pool, names[0]))
        victims = [o for o in up if o >= 0][:2]
        up0, _ = sim.osdmap.map_pgs_batch(2)
        for v in victims:
            sim.kill_osd(v)
        gets = [sim.get(2, n) for n in names]
        for v in victims:
            sim.out_osd(v)
        rec = sim.recover_all(2)
        up1, _ = sim.osdmap.map_pgs_batch(2)
        gets2 = [sim.get(2, n) for n in names]
        sim.shutdown()
    return {"placed": {k: sorted(v) for k, v in placed.items()},
            "datas": datas, "gets": gets, "gets2": gets2, "rec": rec,
            "up0": np.asarray(up0).tolist(),
            "up1": np.asarray(up1).tolist()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cluster_step_bit_identical_and_per_chip_counters(ref_mapper,
                                                          layout):
    """The full cluster step (batched put, degraded get, recovery
    rebuild, remap sweep) on the plane equals the plane-off run and the
    reference's plane run; every cell counts put stripes, and the whole
    ``dataplane`` dump is the reference's."""
    stripes = LAYOUTS[layout]
    single = drive_cluster(PORT, ref_mapper, False)
    reset()
    runs = xor_kernel.plain_runs
    got = drive_cluster(PORT, ref_mapper, True, stripes)
    runs = xor_kernel.plain_runs - runs
    want = drive_cluster(REF, ref_mapper, True, stripes)
    assert got["gets"] == single["gets"] == single["datas"]
    assert got["gets2"] == single["gets2"] == single["datas"]
    for key in single:
        assert got[key] == single[key] == want[key], key
    assert got["rec"]["shards_rebuilt"] > 0
    d = dump(PORT)
    assert d == dump(REF)
    # every K1 trip of the step went through the plane, one per cell
    assert runs == N_CELLS * (d["put_dispatches"] + d["decode_dispatches"] +
                              d["recover_dispatches"])
    for i in range(N_CELLS):
        assert d.get(f"shard{i}.put_stripes", 0) > 0, (i, d)
    for key in ("put_dispatches", "decode_dispatches", "recover_dispatches",
                "map_dispatches", "psum_rows", "allgather_rows"):
        assert d.get(key, 0) > 0, key
    assert any(d.get(f"shard{i}.recover_landed", 0) > 0
               for i in range(N_CELLS))
    assert any(d.get(f"shard{i}.staged_entries", 0) > 0
               for i in range(N_CELLS))
    assert any(d.get(f"shard{i}.subwrites", 0) > 0 for i in range(N_CELLS))
    if stripes:
        assert d.get("r1c3.put_stripes", 0) > 0


def test_plane_off_leaves_no_dataplane_counters(ref_mapper):
    reset()
    drive_cluster(PORT, ref_mapper, False, seed=3, n_objs=4)
    assert dump(PORT) == {}


def objecter(pkg, sim, **kw):
    """An Objecter on ``sim``: it deep-copies the map, so the reference's
    shared mapper (whose jits hold devices) is held aside meanwhile."""
    held = sim.osdmap._mapper
    sim.osdmap._mapper = None
    try:
        return pkg.obj.Objecter(sim, pkg.mon.Monitor(sim.osdmap), **kw)
    finally:
        sim.osdmap._mapper = held


def objecter_put_many(pkg, ref_mapper):
    """The objecter's batched put rides one tracked op whose events show
    the mesh fan-out."""
    with plane_on(pkg):
        sim = make_sim(pkg, ref_mapper)
        client = objecter(pkg, sim)
        pkg.tracker().reset()
        rng = np.random.default_rng(1)
        names = [f"b{i}" for i in range(6)]
        datas = [rng.integers(0, 256, 4000, dtype=np.uint8).tobytes()
                 for _ in names]
        placed = client.put_many(2, names, datas)
        reads = [sim.get(2, n) for n in names]
        hist = pkg.tracker().dump_historic_ops()
        sim.shutdown()
    pm = [o for o in hist["ops"] if o["type"] == "put_many"]
    events = [{k: e[k] for k in ("event", "kind", "shards", "rows")}
              for e in pm[-1]["events"] if e["event"] == "dispatched_mesh"]
    return {"placed": {k: sorted(v) for k, v in placed.items()},
            "ok": reads == datas, "events": events}


def test_objecter_put_many_marks_dispatched_mesh(ref_mapper):
    got = objecter_put_many(PORT, ref_mapper)
    want = objecter_put_many(REF, ref_mapper)
    assert got == want
    assert got["ok"] and got["events"]
    assert got["events"][0]["shards"] == N_CELLS


def test_objecter_put_many_durability_contract(ref_mapper):
    """A batch member that lands fewer than k shards fails the whole
    batched op, in both packages alike."""
    raised = {}
    for pkg in (REF, PORT):
        with plane_on(pkg):
            sim = make_sim(pkg, ref_mapper)
            client = objecter(pkg, sim, max_retries=3)
            for o in range(1, sim.osdmap.max_osd):
                sim.fail_osd(o)
            rng = np.random.default_rng(2)
            with pytest.raises((IOError, pkg.obj.TooManyRetries)) as exc:
                client.put_many(2, ["x0", "x1"],
                                [rng.integers(0, 256, 2000, dtype=np.uint8)
                                 .tobytes()] * 2)
            raised[pkg.name] = type(exc.value).__name__
            sim.shutdown()
    assert raised["port"] == raised["ref"]


@pytest.mark.parametrize("layout", list(DISPATCH_LAYOUTS))
def test_map_pgs_batch_identical_under_mesh(ref_mapper, layout):
    """The remap sweep with the plane's mesh equals the sweep without
    one, and the reference's, for both pools; the lanes split flat over
    every cell."""
    got = {}
    reset()
    for pkg, on in ((PORT, True), (PORT, False), (REF, True)):
        with plane_on(pkg, DISPATCH_LAYOUTS[layout], on=on):
            sim = make_sim(pkg, ref_mapper)
            got[(pkg.name, on)] = [
                [np.asarray(a).tolist() for a in
                 sim.osdmap.map_pgs_batch(p)] for p in (1, 2)]
            if pkg is PORT:
                # every cell lies on the mapper's own device: no twin
                mapper = sim.osdmap._batched_mapper()
                assert mapper._twins == {} and mapper._fast._twins == {}
            sim.shutdown()
    assert got[("port", True)] == got[("port", False)] == got[("ref", True)]
    d = dump(PORT)
    assert d == dump(REF)
    assert d["map_dispatches"] == 2
    assert all(d[f"shard{i}.map_lanes"] == 8 for i in range(N_CELLS))


# ------------------------------------------------------- fused ragged --

RAGGED_SIZES = {"1d": [1, 5, 700, 4096, 4097, 8192, 12289],
                "2x4": [1, 4097, 12289, 700],
                "4x2": [8192, 3, 4096, 20000, 1]}


@pytest.mark.parametrize("layout", list(DISPATCH_LAYOUTS))
def test_fused_ragged_on_the_plane_equals_the_reference(layout):
    """tests/test_ragged_fused.py's plane cases: the block pool split over
    the cells gives the reference plane's parity and every Csums, equal
    to the padded oracle; one K3 trip (its plain version) per cell."""
    from ceph_tpu_torch.ops import gf_pallas
    rng = np.random.default_rng({"1d": 25, "2x4": 26, "4x2": 28}[layout])
    A = gf.isa_rs_parity(4, 2)
    shards = [rng.integers(0, 256, (4, n), dtype=np.uint8)
              for n in RAGGED_SIZES[layout]]
    reset()
    with plane_on(PORT, DISPATCH_LAYOUTS[layout]):
        runs = gf_pallas.plain_runs
        got = ragged_fused.encode(A, shards, impl="plane")
        assert gf_pallas.plain_runs - runs == N_CELLS
        auto = ragged_fused.encode(A, shards)
    with plane_on(REF, DISPATCH_LAYOUTS[layout]):
        want = ref_rf.encode(A, shards)
        ref_rf.encode(A, shards, impl="plane")
    oracle = ref_rf.encode_padded(A, shards)
    for res in (got, auto):
        for r in (want, oracle):
            assert len(res.parity) == len(r.parity)
            for gp, wp in zip(res.parity, r.parity):
                assert np.array_equal(np.asarray(gp), np.asarray(wp))
            for gl, wl in ((res.data_csums, r.data_csums),
                           (res.parity_csums, r.parity_csums)):
                for grow, wrow in zip(gl, wl):
                    for g, w in zip(grow, wrow):
                        assert (g.block, g.subs, g.length, g.combined) == \
                            (w.block, w.subs, w.length, w.combined)
    assert dump(PORT) == dump(REF)
    assert dump(PORT)["ragged_dispatches"] == 2


def test_plane_entry_off_leaves_the_kernel_path(ref_mapper):
    """With the option off an explicit ``impl="plane"`` runs the
    unsharded path, as the reference's does, and counts nothing."""
    rng = np.random.default_rng(27)
    A = gf.isa_rs_parity(4, 2)
    shards = [rng.integers(0, 256, (4, 4097), dtype=np.uint8)]
    reset()
    got = ragged_fused.encode(A, shards, impl="plane")
    want = ref_rf.encode(A, shards, impl="plane")
    assert [np.asarray(p).tolist() for p in got.parity] == \
        [np.asarray(p).tolist() for p in want.parity]
    assert dump(PORT) == dump(REF) == {}


# -------------------------------------------------------- the entry --

@pytest.fixture(scope="module")
def ref_section():
    """The reference's dry-run section on its 8 forced host devices:
    plane off, the 1-D mesh, then the 2 x 4 mesh (``sharded_2d``)."""
    import __graft_entry__ as ref_entry
    return ref_entry._cluster_sharded_impl(N_CELLS)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cluster_sharded_section_equals_the_reference(ref_section, layout):
    """``entry.cluster_sharded`` is ``__graft_entry__._cluster_sharded_impl``
    on 8 cells: the same cluster step plane off then on, asserted
    bit-identical, and the same section (per-cell accounting, dispatch
    counts, the recovery stats)."""
    from ceph_tpu_torch import entry
    stripes = LAYOUTS[layout]
    got = entry.cluster_sharded(N_CELLS, stripes=stripes, device="cpu")
    want = ref_section["sharded_2d"] if stripes else \
        {k: v for k, v in ref_section.items() if k != "sharded_2d"}
    assert got["n_cells"] == N_CELLS

    def moved(cells):
        # the registry keeps zeroed keys of earlier dispatches in the
        # process: compare the counters that moved
        return {c: {k: v for k, v in d.items() if v}
                for c, d in cells.items()}

    for key, val in want.items():
        mine = got["n_cells" if key == "n_devices" else key]
        if key in ("per_chip", "per_cell"):
            mine, val = moved(mine), moved(val)
        assert mine == val, key
    assert got["bit_identical_to_single_device"] is True
    assert got["degraded_get_ok"] is True
    per = got["per_cell" if stripes else "per_chip"]
    assert len(per) == N_CELLS
    assert all(c["put_stripes"] > 0 for c in per.values())
