"""The plain references against the port's CPU path at small sizes, and
the straw2 reference against Ceph's own mapper."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from portbench.reference import rs, straw2


@pytest.fixture(autouse=True)
def cpu():
    ceph_tpu_torch.set_default_device("cpu")


def codec(k, m):
    from ceph_tpu_torch.ec.plugin_jax import ErasureCodeJax
    c = ErasureCodeJax(device="cpu")
    c.init({"k": str(k), "m": str(m), "technique": "reed_sol_van",
            "layout": "bitsliced"})
    return c


@pytest.mark.parametrize("k,m", [(8, 3), (4, 2), (2, 1)])
def test_rs_matrices_match_the_port(k, m):
    from ceph_tpu_torch.ops import gf
    P = rs.parity_matrix(k, m)
    assert (P == gf.vandermonde_parity(k, m)).all()
    assert (rs.bitmatrix(P) == gf.gf8_bitmatrix(P)).all()


@pytest.mark.parametrize("k,m", [(8, 3), (4, 2)])
def test_rs_encode_matches_the_port(k, m):
    g = torch.Generator().manual_seed(k * 10 + m)
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (6, k, 1024),
                          dtype=torch.int32, generator=g)
    assert torch.equal(rs.encode(k, m, words),
                       codec(k, m).encode_words_device(words))
    as_bytes = words.view(torch.uint8).view(6, k, 4096)
    assert torch.equal(rs.encode(k, m, as_bytes).view(torch.int32),
                       rs.encode(k, m, words))


@pytest.mark.parametrize("erased", [[0], [7], [1, 9], [0, 3, 5],
                                    [2, 8, 10], [8, 9, 10]])
def test_rs_decode_recovers_and_matches_the_port(erased):
    k, m = 8, 3
    g = torch.Generator().manual_seed(len(erased) + sum(erased))
    data = torch.randint(0, 256, (5, k, 4096), dtype=torch.uint8,
                         generator=g)
    full = torch.cat([data, rs.encode(k, m, data)], 1)
    avail = [c for c in range(k + m) if c not in erased]
    got = rs.decode(k, m, avail, full[:, avail], erased)
    assert torch.equal(got, full[:, erased])
    port = codec(k, m).decode_chunks_device(avail, full[:, avail], erased)
    assert torch.equal(got, port)


def test_rs_decode_refuses_too_many_erasures():
    with pytest.raises(ValueError):
        rs.inverse(np.zeros((2, 2), dtype=np.uint8))


def test_ln_table_is_the_ports():
    import ceph_tpu_torch.placement.lntable as lt
    assert (straw2._LN == lt.crush_ln_lut()).all()


def test_ln_table_follows_the_log():
    """crush_ln(u) is 2^44 log2(u + 1) in fixed point: every entry lies
    within 2^30 of it (Ceph's tables deviate from their formula by up to
    7.7e8, so the table is not quite monotone)."""
    u = np.arange(65536)
    ideal = np.log2(u + 1.0) * 2.0 ** 44
    assert straw2._LN.dtype == np.int64 and straw2._LN[0] == 0
    assert np.abs(straw2._LN - ideal).max() < 2 ** 30


CEPH = json.loads((Path(__file__).parent / "data" /
                   "ceph_crush_two_level.json").read_text())


@pytest.mark.parametrize("reweights", sorted(CEPH["reweights"]))
@pytest.mark.parametrize("numrep", [3, 5])
def test_straw2_matches_cephs_own_mapper(reweights, numrep):
    """Ceph's crush_do_rule, built from its own sources and ln tables,
    on a map of 6 hosts of 4 OSDs of crush weights 1 and 2: every up set
    of 128 inputs a reweight vector, the reference's equal."""
    cases = [c for c in CEPH["cases"]
             if c[1] == numrep and c[2] == reweights]
    assert len(cases) == 128
    assert CEPH["osds"] == [list(range(4 * h, 4 * h + 4)) for h in range(6)]
    x = torch.tensor([c[0] for c in cases], dtype=torch.int64)
    up, _ = straw2.map_firstn(x, 6, 4,
                              torch.tensor(CEPH["reweights"][reweights]),
                              numrep, host_ids=CEPH["host_ids"],
                              osd_weights=CEPH["osd_weights"])
    got = [[o for o in row if o != straw2.NONE] for row in up.tolist()]
    assert got == [c[3] for c in cases]


@pytest.mark.parametrize("pg_num", [1, 12, 2048, 3000])
def test_pps_match_the_port(pg_num):
    from ceph_tpu_torch.cluster.osdmap import PGPool
    pool = PGPool(id=3, pg_num=pg_num)
    assert (straw2.pps(3, pg_num, "cpu").numpy() ==
            pool.raw_pg_to_pps_batch(np.arange(pg_num))).all()


@pytest.mark.parametrize("outs,partial", [((), ()), ((3,), ()),
                                          ((3, 7, 8), (11,)),
                                          ((), (0, 1, 2))])
def test_straw2_matches_the_ports_mapper(outs, partial):
    from ceph_tpu_torch.cluster.osdmap import OSDMap, PGPool, \
        POOL_REPLICATED
    from ceph_tpu_torch.placement.builder import TYPE_HOST, \
        build_flat_cluster
    from ceph_tpu_torch.placement.crush_map import (
        RULE_CHOOSELEAF_FIRSTN, RULE_EMIT, RULE_TAKE, Rule)
    H, P, N = 40, 5, 4096
    cmap, root = build_flat_cluster(n_hosts=H, osds_per_host=P)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    om = OSDMap(cmap, device="cpu")
    om.mark_all_in_up()
    om.add_pool(PGPool(id=1, type=POOL_REPLICATED, size=3, pg_num=N,
                       crush_rule=0))
    for h in outs:
        om.osd_weight[h * P:(h + 1) * P] = 0
    for o in partial:
        om.osd_weight[o] = 0x6000
    up, _ = om.map_pgs_batch(1)
    ref, draws = straw2.map_firstn(straw2.pps(1, N, "cpu"), H, P,
                                   torch.as_tensor(om.osd_weight), 3)
    assert (ref.numpy() == up.astype(np.int64)).all()
    assert (draws >= 3 * (H + P)).all()



HOSTS, PER, PGS = 50, 5, 2048
FULL = {}


def full_map(host):
    """The reference run in full over all PGS lanes, ``host`` out (None:
    all in): up sets and the whole map's draws."""
    if host not in FULL:
        rw = torch.full((HOSTS * PER,), straw2.WEIGHT_ONE, dtype=torch.int64)
        if host is not None:
            rw[host * PER:(host + 1) * PER] = 0
        up, draws = straw2.map_firstn(straw2.pps(1, PGS, "cpu"), HOSTS, PER,
                                      rw, 3)
        FULL[host] = (up, int(draws.sum()))
    return FULL[host]


@pytest.mark.parametrize("outs", [(), (17,), (3, 41), tuple(range(HOSTS))],
                         ids=["all_in", "one", "two_in_one_batch", "every"])
def test_host_out_maps_equal_the_full_map(outs):
    """One full map with every host in, then only the lanes that each
    host out touches, gives every state's up sets and draws as the full
    reference does, integer for integer."""
    maps = straw2.HostOutMaps(straw2.pps(1, PGS, "cpu"), HOSTS, PER, 3,
                              outs)
    for host in (None,) + outs:
        up, draws = full_map(host)
        assert torch.equal(maps.up(host), up), host
        assert maps.draws(host) == draws, host
    assert sum(len(maps.patch[h][0]) for h in outs) <= 3 * PGS


def test_out_host_is_per_lane():
    """Each lane with its own host out, across blocks, maps as that
    lane does in its host's full map."""
    x = straw2.pps(1, PGS, "cpu")
    owner = torch.arange(PGS) % 7 * 7
    rw = torch.full((HOSTS * PER,), straw2.WEIGHT_ONE, dtype=torch.int64)
    up, draws = straw2.map_firstn(x, HOSTS, PER, rw, 3, block=300,
                                  out_host=owner)
    for h in owner.unique().tolist():
        rows = owner == h
        hw = rw.clone()
        hw[h * PER:(h + 1) * PER] = 0
        ref, ref_draws = straw2.map_firstn(x[rows], HOSTS, PER, hw, 3)
        assert torch.equal(up[rows], ref), h
        assert torch.equal(draws[rows], ref_draws), h
