"""The fast mapper's descent kernel (``ops/crush_descend.py``,
``csrc/crush_descend.cu``) and the lane chunk that follows its path.

The first tests need no card: the chunk cap on each path, the row counts,
the build's source list, the packed tables, the reciprocal quotient's
exactness and the wrapper's refusals.  The ``cuda`` ones hold the kernel
to its plain version, ``fast_mapper._descend_batch``, run on the same
card, bit for bit; they skip without a card, and run there with

    python -m pytest -m cuda tests/test_torch_crush_descend.py

The file imports no JAX.
"""
import numpy as np
import pytest
import torch

from ceph_tpu_torch.common.options import config
from ceph_tpu_torch.ops import _build, crush_descend
from ceph_tpu_torch.placement import fast_mapper as fm_mod
from ceph_tpu_torch.placement import lntable
from ceph_tpu_torch.placement.builder import (TYPE_HOST, TYPE_OSD,
                                              build_flat_cluster)
from ceph_tpu_torch.placement.crush_map import (
    BUCKET_STRAW2, RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP,
    RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP, RULE_EMIT,
    RULE_SET_CHOOSELEAF_STABLE, RULE_TAKE, Bucket, ChooseArg, Rule,
    WEIGHT_ONE)
from ceph_tpu_torch.placement.fast_mapper import FastMapper
from ceph_tpu_torch.placement.xla_mapper import _straw2_select, compile_map

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the descent kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


def rule_map(n_hosts, osds, op=RULE_CHOOSELEAF_FIRSTN, target=TYPE_HOST,
             **kw):
    cmap, root = build_flat_cluster(n_hosts=n_hosts, osds_per_host=osds,
                                    **kw)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0), (op, 0, target),
                              (RULE_EMIT, 0, 0)]))
    return cmap, root


def odd_map():
    """A straw2 map with every case a level can meet: unequal weights,
    zero weights (one whole host), the largest 16.16 weight an int32
    holds, an empty host, a missing bucket and a device past
    max_devices under the root."""
    cmap, root = build_flat_cluster(n_hosts=12, osds_per_host=5, seed=3,
                                    weight_jitter=True)
    cmap.bucket(-1).weights[1] = 0
    cmap.bucket(-1).weights[2] = 0x7FFFFFFF
    cmap.bucket(-2).weights[:] = [0] * 5
    cmap.add_bucket(Bucket(id=-40, alg=BUCKET_STRAW2, type=TYPE_HOST,
                           items=[], weights=[]))
    rb = cmap.bucket(root)
    rb.items += [-40, -77, 1000]
    rb.weights += [WEIGHT_ONE] * 3
    cmap.finalize()
    cmap.max_devices = 60
    return cmap, root


def positions_map(P=3):
    """choose_args with P weight-set positions (per-rep grids)."""
    cmap, root = build_flat_cluster(n_hosts=6, osds_per_host=3, seed=7)
    rng = np.random.default_rng(1)
    cmap.choose_args["p"] = [
        None if b is None else ChooseArg(ids=None, weight_set=[
            [int(v * (0.5 + rng.random())) for v in b.weights]
            for _ in range(P)]) for b in cmap.buckets]
    return cmap, root


def host_levels(cmap, roots, target, key=None):
    cm = compile_map(cmap, key, n_positions=3 if key is not None else 1)
    levels, _ = fm_mod._build_levels(cmap, cm, roots, target)
    return cm, levels


# --------------------------------------------------------------- the CPU --

def test_sources_list_the_descent_kernel():
    assert "crush_descend" in _build.sources()


def test_chunk_cap_follows_the_path():
    """On the CPU the plain version's [rows, width] buffers bound the
    chunk (about 28,760 lanes on the remap cell's map); a mapper told
    that its device is CUDA takes the grid-lane cap, bounded by the
    kernel path's [rows] buffers (one chunk of the 262,144 lanes)."""
    cmap, _ = rule_map(1000, 10)
    fm = FastMapper(cmap, device="cpu")
    gw = fm.grid_width(0, 3)
    assert gw == 3 + int(config().get("fastmap_extra_tries"))
    max_grid = int(config().get("fastmap_max_grid_lanes"))
    budget = int(config().get("fastmap_max_grid_mib")) * (1 << 20)
    width = fm.max_level_width(0, 3)
    assert width == 1000
    cpu_cap = fm.chunk_lanes(0, 3)
    assert cpu_cap == max(1 << 10, min(
        max_grid // gw, budget // (8 * fm_mod._LEVEL_BUFFERS * width * gw)))
    assert cpu_cap == 28760
    fm.device = torch.device("cuda")       # the plan is built: no upload
    cuda_cap = fm.chunk_lanes(0, 3)
    assert cuda_cap == min(max_grid // gw,
                           budget // (8 * fm_mod._KERNEL_ROW_BUFFERS * gw))
    assert cuda_cap == max_grid // gw and cuda_cap >= 262144


@pytest.mark.parametrize("op,rm", [(RULE_CHOOSELEAF_FIRSTN, 3),
                                   (RULE_CHOOSELEAF_INDEP, 4)])
def test_plain_path_counts_its_rows(op, rm):
    cmap, _ = rule_map(8, 4, op=op)
    fm = FastMapper(cmap, device="cpu")
    fc = next(e[1] for e in fm._plan(0, rm) if e[0] == "choose")
    n = 100
    k0 = (crush_descend.launches, crush_descend.descend_kernel_rows)
    t0 = crush_descend.descend_torch_rows
    fm.map_batch(0, np.arange(n), rm, [WEIGHT_ONE] * cmap.max_devices)
    leaf = fc.R * fc.spec.recurse_tries
    assert crush_descend.descend_torch_rows - t0 == n * (fc.R + leaf)
    assert (crush_descend.launches,
            crush_descend.descend_kernel_rows) == k0


def test_cpu_mapper_packs_nothing_and_keeps_the_plain_tables():
    cmap, _ = rule_map(8, 4)
    fc = next(e[1] for e in FastMapper(cmap, device="cpu")._plan(0, 3)
              if e[0] == "choose")
    for d in list(fc.levels.values()) + list(fc.leaf_levels.values()):
        assert d.packed is None
        assert [lv.Sl for lv in d.levels] == d.widths


@pytest.mark.parametrize("case", ["odd", "three_levels", "positions"])
def test_packed_records_decode_to_the_level_tables(case):
    if case == "odd":
        cmap, root = odd_map()
        cm, levels = host_levels(cmap, [root], TYPE_OSD)
        pos = 0
    elif case == "three_levels":
        cmap, root = build_flat_cluster(n_hosts=12, osds_per_host=3,
                                        n_racks=3, weight_jitter=True)
        cm, levels = host_levels(cmap, [root], TYPE_OSD)
        pos = 0
    else:
        cmap, root = positions_map()
        cm, levels = host_levels(cmap, [root], TYPE_OSD, key="p")
        pos = 2
    d = fm_mod._Descent(levels, pos, CPU)
    tabs = crush_descend.pack(
        [(h.items, h.hash_ids, h.weights[:, pos, :], h.sizes, h.child_row,
          h.child_type, h.child_escape, h.child_leafrow) for h in levels],
        CPU)
    assert tabs.n_levels == len(levels) == len(d.levels)
    hot = tabs.items.numpy()
    cold = tabs.children.numpy()
    for (ioff, soff, rows, width), lv in zip(tabs.desc, d.levels):
        assert (rows, width) == (lv.Bl, lv.Sl)
        n = rows * width
        h = hot[ioff:ioff + n]
        c = cold[ioff:ioff + n]
        hid = (h[:, 0] & 0xFFFFFFFF).astype(np.uint32).astype(np.int32)
        w = (h[:, 0] >> 32).astype(np.int64)
        rcp = h[:, 1].view(np.float64)
        assert np.array_equal(hid, lv.hash_ids.reshape(-1).numpy())
        assert np.array_equal(w, lv.weights.reshape(-1).numpy())
        assert np.array_equal(rcp, np.where(w > 0, 1.0 / np.maximum(w, 1),
                                            0.0))
        assert np.array_equal(c[:, 0], lv.items.reshape(-1).numpy())
        esc = (c[:, 1] & crush_descend.ESCAPE) != 0
        assert np.array_equal(esc, lv.child_escape.reshape(-1).numpy())
        assert np.array_equal(c[:, 1] & ~crush_descend.ESCAPE,
                              lv.child_type.reshape(-1).numpy())
        assert np.array_equal(c[:, 2], lv.child_row.reshape(-1).numpy())
        assert np.array_equal(c[:, 3], lv.child_leafrow.reshape(-1).numpy())
        assert np.array_equal(tabs.sizes.numpy()[soff:soff + rows],
                              lv.sizes.numpy())
    if case == "odd":
        assert any(lv.child_escape.any() for lv in d.levels)
        assert any((lv.sizes == 0).any() for lv in d.levels)
    else:
        assert any(lv.Bl > 1 for lv in d.levels)


def test_reciprocal_quotient_is_exact_for_every_u():
    """The kernel's quotient, floor(numer * rcp(w)) corrected one step
    each way in float64, is the integer quotient for all 65,536 values of
    u against weights from 1 to the largest int32 16.16 value (NumPy's
    float64 rounds as the card's DMUL and floor do)."""
    numer_i = -lntable.straw2_ln_lut()              # 2^48 - crush_ln(u)
    numer = numer_i.astype(np.float64)
    rng = np.random.default_rng(11)
    ws = np.unique(np.concatenate([
        np.arange(1, 65), 1 << np.arange(31), (1 << np.arange(1, 32)) - 1,
        [WEIGHT_ONE * k for k in (1, 3, 7, 10, 1000, 32767)],
        rng.integers(1, 2 ** 31, 64)])).astype(np.int64)
    assert ws.max() == 2 ** 31 - 1
    rcp = crush_descend.reciprocals(ws)
    for w, rc in zip(ws, rcp):
        wf = float(w)
        q = np.floor(numer * rc)
        q = q - (q * wf > numer)
        q = q + ((q + 1.0) * wf <= numer)
        assert np.array_equal(q.astype(np.int64), numer_i // w), w


def test_wrapper_refuses_before_any_launch(monkeypatch):
    cmap, root = rule_map(4, 3)
    cm, levels = host_levels(cmap, [root], TYPE_HOST)
    tabs = crush_descend.pack(
        [(h.items, h.hash_ids, h.weights[:, 0, :], h.sizes, h.child_row,
          h.child_type, h.child_escape, h.child_leafrow) for h in levels],
        CPU)
    numer = cm.tables(CPU).numer_lut

    def no_launch():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(crush_descend, "_lib", no_launch)
    launches = crush_descend.launches
    x = torch.arange(10, dtype=torch.int64)
    grid = torch.zeros((10, 7), dtype=torch.int64)
    r = torch.arange(7, dtype=torch.int64).expand(10, 7)
    with pytest.raises(ValueError, match="CUDA"):
        crush_descend.descend(tabs, numer, x, grid, grid.clone(),
                              TYPE_HOST, True)
    with pytest.raises(TypeError, match="int64"):
        crush_descend.descend(tabs, numer, x.to(torch.int32), grid, grid,
                              TYPE_HOST, True)
    with pytest.raises(TypeError, match="int64"):
        crush_descend.descend(tabs, numer, x, grid, grid.to(torch.int32),
                              TYPE_HOST, True)
    with pytest.raises(ValueError, match="contiguous"):
        crush_descend.descend(tabs, numer, x, grid, r, TYPE_HOST, True)
    with pytest.raises(ValueError, match="contiguous"):
        crush_descend.descend(tabs, numer, x, grid.t().contiguous().t(),
                              grid, TYPE_HOST, True)
    with pytest.raises(ValueError, match=r"\[N, K\]"):
        crush_descend.descend(tabs, numer, x[:5], grid, grid, TYPE_HOST,
                              True)
    with pytest.raises(TypeError, match="numerator"):
        crush_descend.descend(tabs, numer.float(), x, grid, grid, TYPE_HOST,
                              True)
    with pytest.raises(ValueError, match="group"):
        crush_descend.descend(tabs, numer, x, grid, grid, TYPE_HOST, True,
                              group=8)
    assert crush_descend.launches == launches


def test_pack_refuses_what_the_kernel_cannot_walk():
    cmap, root = rule_map(4, 3)
    _, levels = host_levels(cmap, [root], TYPE_OSD)
    lv = levels[0]
    one = (lv.items, lv.hash_ids, lv.weights[:, 0, :], lv.sizes,
           lv.child_row, lv.child_type, lv.child_escape, lv.child_leafrow)
    with pytest.raises(ValueError, match="levels"):
        crush_descend.pack([], CPU)
    with pytest.raises(ValueError, match="levels"):
        crush_descend.pack([one] * (crush_descend.MAX_LEVELS + 1), CPU)
    bad = list(one)
    bad[5] = np.full_like(lv.child_type, crush_descend.ESCAPE)
    with pytest.raises(ValueError, match="type"):
        crush_descend.pack([tuple(bad)], CPU)


# ---------------------------------------------------------------- the card --

def plain_and_kernel(card, levels, pos, dt, target, x, row0, r, want,
                     group):
    devl = [fm_mod._DevLevel(h, pos, card) for h in levels]
    K = row0.shape[1]
    want_t = fm_mod._descend_batch(
        devl, dt, target, row0.reshape(-1), x.repeat_interleave(K),
        r.reshape(-1), want)
    d = fm_mod._Descent(levels, pos, card)
    got = crush_descend.descend(d.packed, dt.numer_lut, x, row0, r, target,
                                want, group=group)
    torch.cuda.synchronize()
    return [t.reshape(-1) for t in got], list(want_t)


def grids(card, levels, N, K, seed, r_max=60):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.integers(0, 2 ** 32, N - 3),
                        [0, 2 ** 31, 2 ** 32 - 1]]).astype(np.int64)
    r = rng.integers(0, r_max, (N, K)).astype(np.int64)
    row0 = rng.integers(-1, levels[0].items.shape[0], (N, K)).astype(
        np.int64)
    return tuple(torch.as_tensor(a, device=card) for a in (x, row0, r))


CASES = {
    # (map, roots as a function of the map's root, target, pos)
    "odd_parent": (odd_map, lambda c, r: [r], TYPE_HOST, None, 0),
    "odd_to_osd": (odd_map, lambda c, r: [r], TYPE_OSD, None, 0),
    "odd_hosts_first": (odd_map, lambda c, r: [-1, -2, -3, -40, -4],
                        TYPE_OSD, None, 0),
    "three_levels": (lambda: build_flat_cluster(
        n_hosts=40, osds_per_host=4, n_racks=5, weight_jitter=True, seed=9),
        lambda c, r: [r], TYPE_OSD, None, 0),
    "racks_first": (lambda: build_flat_cluster(
        n_hosts=40, osds_per_host=4, n_racks=5, weight_jitter=True, seed=9),
        lambda c, r: list(c.bucket(r).items), TYPE_OSD, None, 0),
    "positions": (positions_map, lambda c, r: [r], TYPE_HOST, "p", 2),
    "wide_root": (lambda: build_flat_cluster(
        n_hosts=1000, osds_per_host=10, weight_jitter=True, seed=4),
        lambda c, r: [r], TYPE_HOST, None, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("group", [None, 1, 4, 32])
def test_kernel_equals_plain_version(card, case, group):
    make, roots, target, key, pos = CASES[case]
    cmap, root = make()
    cm, levels = host_levels(cmap, roots(cmap, root), target, key)
    dt = cm.tables(card)
    for N, K, seed in ((1021, 7, 1), (37, 3, 2)):
        x, row0, r = grids(card, levels, N, K, seed)
        for want in (True, False):
            got, want_t = plain_and_kernel(card, levels, pos, dt, target, x,
                                           row0, r, want, group)
            for g, w, name in zip(got, want_t,
                                  ("item", "status", "leafrow")):
                assert torch.equal(g, w), (case, group, N, want, name)


@pytest.mark.cuda
def test_kernel_fills_the_card_with_a_thread_a_row(card):
    """Rows enough to fill the card take one thread a row, fewer take 4
    lanes a row, or 32 over a level of 256 items or more while 4 would
    leave the card short; the grid is not a multiple of the block."""
    cmap, root = build_flat_cluster(n_hosts=1000, osds_per_host=10,
                                    weight_jitter=True, seed=6)
    cm, levels = host_levels(cmap, [root], TYPE_HOST)
    dt = cm.tables(card)
    x, _, r = grids(card, levels, 40001, 7, 3)
    row0 = torch.zeros_like(r)
    d = fm_mod._Descent(levels, 0, card)
    fill = 2048 * torch.cuda.get_device_properties(card).multi_processor_count
    assert crush_descend.group_for(d.packed, 40001 * 7) == 1
    assert crush_descend.group_for(d.packed, 1000) == 32
    assert crush_descend.group_for(d.packed, fill // 2) == 4
    narrow, nroot = rule_map(32, 4)
    _, nlevels = host_levels(narrow, [nroot], TYPE_HOST)
    nd = fm_mod._Descent(nlevels, 0, card)
    assert crush_descend.group_for(nd.packed, 1000) == 4
    got, want_t = plain_and_kernel(card, levels, 0, dt, TYPE_HOST, x, row0,
                                   r, True, None)
    assert all(torch.equal(g, w) for g, w in zip(got, want_t))


@pytest.mark.cuda
def test_quotient_every_u_against_the_plain_draw(card):
    """All 65,536 u against a range of weights: the kernel's quotient is
    ln_numer(u) // w, and the first least quotient of each row of 16 is
    the item ``_straw2_select`` picks."""
    cmap, _ = rule_map(4, 3)
    dt = compile_map(cmap).tables(card)
    rng = np.random.default_rng(5)
    ws = np.unique(np.concatenate([
        np.arange(1, 33), 1 << np.arange(31), (1 << np.arange(1, 32)) - 1,
        rng.integers(1, 2 ** 31, 32)])).astype(np.int64)
    u = np.tile(np.arange(65536, dtype=np.int64), len(ws))
    w = np.repeat(ws, 65536)
    q = crush_descend.quotients(dt.numer_lut, u, w)
    u_d = torch.as_tensor(u, device=card)
    w_d = torch.as_tensor(w, device=card)
    exact = dt.ln_numer(u_d).to(torch.int64) // w_d
    assert torch.equal(q, exact)
    perm = torch.as_tensor(rng.permutation(len(u)), device=card)
    rows = len(u) // 16
    sel = perm[:rows * 16].reshape(rows, 16)
    j = _straw2_select(dt, u_d[sel], w_d[sel],
                       torch.full((rows,), 16, device=card))
    assert torch.equal(torch.argmin(q[sel], dim=1), j)
    zero = crush_descend.quotients(dt.numer_lut, np.arange(4),
                                   np.array([0, -1, -5, 0]))
    assert (zero == -1).all()


RULES = {
    "firstn_leaf": [(RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST)],
    "indep_leaf": [(RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST)],
    "firstn_osd": [(RULE_CHOOSE_FIRSTN, 0, TYPE_OSD)],
    "indep_osd": [(RULE_CHOOSE_INDEP, 0, TYPE_OSD)],
    "unstable_leaf": [(RULE_SET_CHOOSELEAF_STABLE, 0, 0),
                      (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("shape", ["odd", "racks", "positions"])
def test_mapper_on_card_equals_cpu(card, rule, shape):
    """Whole map_batch calls, firstn and indep grids, per-rep grids (P > 1
    choose_args, unstable chooseleaf): the card, through the kernel, equals
    the CPU's plain version lane for lane, incomplete flags included."""
    key = None
    if shape == "odd":
        cmap, root = odd_map()
    elif shape == "racks":
        cmap, root = build_flat_cluster(n_hosts=40, osds_per_host=4,
                                        n_racks=5, weight_jitter=True)
    else:
        cmap, root = positions_map()
        key = "p"
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0)] + RULES[rule] +
                       [(RULE_EMIT, 0, 0)]))
    w = [WEIGHT_ONE] * cmap.max_devices
    w[3], w[7] = 0, 0x8000
    xs = np.concatenate([np.arange(3001), [2 ** 31 - 1, 2 ** 32 - 1]])
    rows0 = crush_descend.descend_kernel_rows
    a = FastMapper(cmap, choose_args_key=key, device=card).map_batch(
        0, xs, 4, w)
    b = FastMapper(cmap, choose_args_key=key, device="cpu").map_batch(
        0, xs, 4, w)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert crush_descend.descend_kernel_rows > rows0


@pytest.mark.cuda
def test_descent_captured_in_a_cuda_graph_equals_eager(card):
    cmap, root = build_flat_cluster(n_hosts=100, osds_per_host=10)
    cm, levels = host_levels(cmap, [root], TYPE_OSD)
    dt = cm.tables(card)
    d = fm_mod._Descent(levels, 0, card)
    x, row0, r = grids(card, levels, 4099, 7, 8)
    eager = crush_descend.descend(d.packed, dt.numer_lut, x, row0, r,
                                  TYPE_OSD, True)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = crush_descend.descend(d.packed, dt.numer_lut, x, row0, r,
                                    TYPE_OSD, True)
    g.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager, out))
    crush_descend.descend_floor(d.packed, 4099, 7)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_tensor_never_reaches_plain_version(card, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(fm_mod, "_descend_batch", refuse)
    cmap, _ = rule_map(16, 4)
    t0 = crush_descend.descend_torch_rows
    out, inc = FastMapper(cmap, device=card).map_batch(
        0, np.arange(5000), 3, [WEIGHT_ONE] * cmap.max_devices)
    assert crush_descend.descend_torch_rows == t0
    assert out.shape == (5000, 3)

