"""The port's multi-process plane boot (parallel/multihost.py) against
ceph_tpu's.

Twin of tests/test_multihost.py.  The load-bearing contract is the
fallback: with no coordinator configured every entry point answers as a
single process, in both packages alike.  The fleet itself runs as two
gloo processes through ``ceph_tpu_torch/tools/check_multihost.py``: a
global 2 x 4 mesh, the bytes of the 8-cell single-process run, and the
per-(host, cell) counters rolled up to the single-process totals.  The
cross-rank helpers also run on a one-rank gloo group in the test
process.
"""
import datetime
import socket
import time

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.common.options import config as ref_config
from ceph_tpu.parallel import multihost as ref_multihost
from ceph_tpu_torch.common.options import config
from ceph_tpu_torch.parallel import mesh, multihost

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

N_CELLS = 8


@pytest.fixture(autouse=True)
def cells8():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    mesh.cells_per_device = N_CELLS
    yield
    mesh.cells_per_device = 1
    ceph_tpu_torch.set_default_device(prev)
    config().clear("parallel_data_plane")
    config().clear("parallel_data_plane_stripes")


def test_fallback_is_noop():
    """No coordinator configured: ensure_initialized declines and the
    rank reads report the single process, as the reference's do."""
    for mh in (ref_multihost, multihost):
        assert mh.ensure_initialized() is False
        assert mh.is_active() is False
        assert mh.process_index() == 0
        assert mh.process_count() == 1
        assert mh.host_label() == "host0"
        assert mh.host_label(3) == "host3"


def test_one_process_is_no_fleet(monkeypatch):
    """A coordinator with fewer than two processes stays single-process
    (the reference's rule); the environment wins over the options."""
    for mh, cfg in ((ref_multihost, ref_config()), (multihost, config())):
        monkeypatch.setenv(mh.ENV_COORDINATOR, "127.0.0.1:1")
        monkeypatch.setenv(mh.ENV_NUM_PROCESSES, "1")
        monkeypatch.setenv(mh.ENV_PROCESS_ID, "0")
        cfg.set("multihost_processes", 4)
        try:
            assert mh._spec() == ("127.0.0.1:1", 1, 0)
        finally:
            cfg.clear("multihost_processes")
    assert multihost.ensure_initialized() is False
    assert multihost.backend() == "gloo"


def test_fallback_stripe_order_is_identity():
    for mh in (ref_multihost, multihost):
        assert mh.stripe_order([]) == []
        assert mh.stripe_order([9, 4, 7, 1]) == [0, 1, 2, 3]


def test_stripe_order_interleaves_across_hosts(monkeypatch):
    hosts = {10: 0, 11: 0, 12: 1, 13: 1, 14: 0}
    for mh in (ref_multihost, multihost):
        monkeypatch.setattr(mh, "_active", True)
        assert mh.stripe_order([10, 11, 12, 13, 14],
                               host_of=lambda t: hosts[t]) == \
            [0, 2, 1, 3, 4]
        assert mh.stripe_order([10, 11], host_of=lambda t: 0) == [0, 1]


def test_global_mesh_2d_single_process():
    """Single-process the global mesh is one stripe row over the local
    cells; an explicit row count reshapes them; every cell is rank 0's."""
    import jax
    assert len(jax.devices()) == N_CELLS
    for rows in (None, 2):
        got = multihost.global_mesh_2d(rows)
        want = ref_multihost.global_mesh_2d(rows)
        assert got.devices.shape == want.devices.shape
        for flat in range(got.size):
            assert multihost.host_of_chip(got, flat) == \
                ref_multihost.host_of_chip(want, flat) == 0


def test_disabled_mode_byte_identity():
    """With multihost imported and inactive, the sharded plane's dispatch
    equals the single-device kernel and the reference's plane."""
    from ceph_tpu.ops import xor_kernel as ref_xor
    from ceph_tpu.parallel import data_plane as ref_dp
    from ceph_tpu_torch.ops import gf, xor_kernel
    from ceph_tpu_torch.parallel import data_plane as dpmod
    assert multihost.ensure_initialized() is False
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2 ** 31, (3, 32, 16), dtype=np.uint32)
    bm = gf.gf8_bitmatrix(gf.vandermonde_parity(4, 2))
    config().set("parallel_data_plane", True)
    ref_config().set("parallel_data_plane", True)
    try:
        out = dpmod.plane().xor_matmul_w32(
            xor_kernel.masks_to_device(bm), words).numpy()
        ref = np.asarray(ref_dp.plane().xor_matmul_w32(
            ref_xor.masks_to_device(bm), words))
    finally:
        ref_config().clear("parallel_data_plane")
    assert np.array_equal(out, ref)
    assert np.array_equal(out, xor_kernel.xor_matmul_w32(
        xor_kernel.masks_to_device(bm), words.astype(np.int32)).numpy())


def test_mesh_rollup_alias_dedup():
    """The port's ClusterStats rolls the plane's per-cell counters up as
    the reference's does: coordinate keys win over shard aliases, and
    alias-only reporters attribute to host0 with no grid shape."""
    from ceph_tpu.mgr.cluster_stats import ClusterStats as RefStats
    from ceph_tpu_torch.mgr.cluster_stats import ClusterStats
    grp = {"r0c0.put_stripes": ("counter", 5),
           "r0c1.put_stripes": ("counter", 7),
           "shard0.put_stripes": ("counter", 5),
           "shard1.put_stripes": ("counter", 7),
           "psum_rows": ("counter", 99)}
    alias = {"shard1.put_stripes": ("counter", 3)}
    rolls = []
    for cls in (RefStats, ClusterStats):
        stats = cls()
        stats.ingest("client.host0", {"perf": {"dataplane": grp},
                                      "ts": time.time(), "host": "host0"})
        only = cls()
        only.ingest("client", {"perf": {"dataplane": alias},
                               "ts": time.time()})
        rolls.append((stats.mesh_rollup(), only.mesh_rollup()))
    assert rolls[0] == rolls[1]
    roll, r2 = rolls[1]
    assert roll["totals"] == {"put_stripes": 12.0}
    assert roll["n_hosts"] == 1 and roll["n_chips"] == 2
    assert roll["shape"] == [1, 2]
    assert r2["hosts"]["host0"]["shard1"]["put_stripes"] == 3.0
    assert r2["shape"] is None


def test_cross_rank_helpers_on_a_one_rank_group():
    """all_reduce, the tiled all-gather and the point-to-point exchange
    on a one-rank gloo group: each equals the result inside the process
    (the card's smoke runs the same helpers on a one-rank NCCL group)."""
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=30))
    try:
        t = torch.arange(12, dtype=torch.int64).reshape(3, 4)
        assert torch.equal(multihost.all_reduce_sum(t), t)
        blocks = [torch.full((2, 3), i, dtype=torch.int32) for i in range(4)]
        got = multihost.all_gather_cells(blocks, "cpu")
        assert torch.equal(got, torch.stack(blocks))
        multihost.exchange([], [])
    finally:
        dist.destroy_process_group()
    assert not multihost.is_active()


def test_check_multihost_fleet():
    """``ceph_tpu_torch/tools/check_multihost.py`` passes: the fallback
    no-op, the single-process 2-D reference, and two gloo processes of 4
    CPU cells each on one global 2 x 4 mesh giving the single-process
    bytes, each rank counting only its own row, and the rollup totals
    equal to the single-process run's."""
    from ceph_tpu_torch.tools import check_multihost
    assert check_multihost.main([]) == 0
