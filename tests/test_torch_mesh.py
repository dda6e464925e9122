"""The port's meshes (parallel/mesh.py) against ceph_tpu's.

The reference's tests force 8 host devices (tests/conftest.py); the
port's twin is 8 CPU cells (``mesh.cells_per_device = 8`` with the CPU
asked for).  Every comparison is exact:

  * the axis vocabulary, ``make_mesh`` / ``make_mesh_2d`` shapes, the
    divisibility errors and the axes ``lane_shardings`` /
    ``batch_sharding`` / ``replicated_sharding`` split over equal the
    reference's specs;
  * ``distributed_encode_step`` (K2's plain version on a CPU cell) and
    ``distributed_xor_encode_step`` (K1's) give the reference's parity
    and byte counter on the 1-D, the 2 x 4 and the 4 x 2 mesh;
  * a mesh may repeat a device (the divergence ROADMAP section C
    records): the reference's plane refuses one, the port's runs it.
"""
import jax
import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.ops import gf as ref_gf
from ceph_tpu.ops import gf2 as ref_gf2
from ceph_tpu.parallel import mesh as ref_mesh
from ceph_tpu_torch.ops import gf, gf2, xor_kernel
from ceph_tpu_torch.parallel import mesh

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


def both_meshes(layout):
    """(port, reference) meshes of one layout: the 1-D ring, 2 x 4 or
    4 x 2."""
    if layout == "1d":
        return mesh.make_mesh(N_CELLS), ref_mesh.make_mesh(N_CELLS)
    rows = int(layout.split("x")[0])
    return mesh.make_mesh_2d(rows), ref_mesh.make_mesh_2d(rows)


def test_axes_meshes_and_splits_equal_the_reference():
    """make_mesh_2d reshapes the cell list row-major into (STRIPE,
    SHARD); a (1, n) mesh is a drop-in for the 1-D lane; the splits name
    the axes the reference's PartitionSpecs name."""
    from jax.sharding import PartitionSpec as P
    assert mesh.MESH_AXES == ref_mesh.MESH_AXES == \
        (mesh.STRIPE_AXIS, mesh.SHARD_AXIS)
    assert (mesh.SHARD_AXIS, mesh.STRIPE_AXIS) == \
        (ref_mesh.SHARD_AXIS, ref_mesh.STRIPE_AXIS)
    n = len(jax.devices())
    assert len(mesh.global_devices()) == n == N_CELLS
    for args in ((1, n), (2,), (1,), (4, 2)):
        got, want = mesh.make_mesh_2d(*args), ref_mesh.make_mesh_2d(*args)
        assert got.axis_names == want.axis_names == mesh.MESH_AXES
        assert got.devices.shape == want.devices.shape
        assert got.shape == dict(want.shape)
        assert got.size == want.size
    row = mesh.make_mesh_2d(1, n)
    assert [c.device for c in row.devices[0]] == \
        [torch.device("cpu")] * n
    assert all(c.rank == 0 for c in row.devices.flat)
    for (pm, rm), lead in (
            ((mesh.make_mesh(n), ref_mesh.make_mesh(n)), mesh.SHARD_AXIS),
            ((row, ref_mesh.make_mesh_2d(1, n)), tuple(mesh.MESH_AXES))):
        batch, repl = mesh.lane_shardings(pm)
        rbatch, rrepl = ref_mesh.lane_shardings(rm)
        assert rbatch.spec == P(lead) and rrepl.spec == P()
        assert batch.axes == (lead if isinstance(lead, tuple) else (lead,))
        assert repl.axes == ()
        assert mesh.batch_sharding(pm).axes == (mesh.SHARD_AXIS,)
        assert ref_mesh.batch_sharding(rm).spec == P(mesh.SHARD_AXIS)
        assert mesh.replicated_sharding(pm).axes == ()
    for bad in ((n + 1, n + 1), (n + 1,)):
        with pytest.raises(ValueError) as got:
            mesh.make_mesh_2d(*bad)
        with pytest.raises(ValueError) as want:
            ref_mesh.make_mesh_2d(*bad)
        assert ("stripe count that divides" in str(got.value)) == \
            ("stripe count that divides" in str(want.value))
    with pytest.raises(ValueError):
        mesh.make_mesh_2d(0)


def test_split_blocks_follow_the_row_major_grid():
    """A split's block of each cell: the lane split cuts flat over both
    axes, the batch split over the shard columns, replicated none."""
    m2 = mesh.make_mesh_2d(2)
    lane, repl = mesh.lane_shardings(m2)
    batch = mesh.batch_sharding(m2)
    assert (lane.blocks, batch.blocks, repl.blocks) == (8, 4, 1)
    assert [lane.block_of(i) for i in range(8)] == list(range(8))
    assert [batch.block_of(i) for i in range(8)] == [0, 1, 2, 3] * 2
    assert [repl.block_of(i) for i in range(8)] == [0] * 8
    stripe = mesh.Split(m2, (mesh.STRIPE_AXIS,))
    assert [stripe.block_of(i) for i in range(8)] == [0] * 4 + [1] * 4


def test_mesh_cache_key_tells_meshes_apart():
    a, b = mesh.make_mesh(4), mesh.make_mesh(4)
    assert mesh.mesh_cache_key(a) == mesh.mesh_cache_key(b)
    assert mesh.mesh_cache_key(a) != \
        mesh.mesh_cache_key(mesh.make_mesh_2d(2, 2))
    assert mesh.mesh_cache_key(a) != mesh.mesh_cache_key(
        mesh.make_mesh(4, devices=[mesh.Cell(1, torch.device("cpu"))] * 4))


def test_cells_follow_the_package_device():
    """The resolved cell list: the package default's devices, each
    ``cells_per_device`` times; one cell at the default count; a CUDA
    default without a card raises."""
    assert mesh.local_devices() == [torch.device("cpu")] * N_CELLS
    mesh.cells_per_device = 1
    assert mesh.global_devices() == [mesh.Cell(0, torch.device("cpu"))]
    if not torch.cuda.is_available():
        ceph_tpu_torch.set_default_device("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.local_devices()


@pytest.mark.parametrize("layout", ["1d", "2x4", "4x2"])
def test_distributed_encode_step_equals_the_reference(layout):
    """K2's math over the mesh (the reference's plain XLA math, the
    port's ``gf_pallas.bitplane_matmul`` per cell): the same parity and
    the same byte counter, the int64 sum of the bytes' values."""
    import jax.numpy as jnp
    pm, rm = both_meshes(layout)
    rng = np.random.default_rng(0)
    bitmat = gf.gf8_bitmatrix(gf.vandermonde_parity(4, 2))
    assert (bitmat == ref_gf.gf8_bitmatrix(
        ref_gf.vandermonde_parity(4, 2))).all()
    data = rng.integers(0, 256, (2 * N_CELLS, 4, 512), dtype=np.uint8)
    out, total = mesh.distributed_encode_step(pm, bitmat,
                                              torch.from_numpy(data))
    rout, rtotal = ref_mesh.distributed_encode_step(
        rm, jnp.asarray(bitmat), jnp.asarray(data))
    assert out.shape == (2 * N_CELLS, 2, 512) and out.dtype == torch.uint8
    assert np.array_equal(out.numpy(), np.asarray(rout))
    assert int(total) == int(rtotal) == int(data.astype(np.int64).sum())
    with pytest.raises(ValueError, match="split"):
        mesh.distributed_encode_step(pm, bitmat,
                                     torch.from_numpy(data[:3]))


@pytest.mark.parametrize("layout", ["1d", "2x4", "4x2"])
def test_distributed_xor_encode_step_equals_the_reference(layout):
    pm, rm = both_meshes(layout)
    rng = np.random.default_rng(1)
    masks = gf2.bitmatrix_masks(gf.gf8_bitmatrix(gf.vandermonde_parity(4, 2)))
    assert (masks == ref_gf2.bitmatrix_masks(ref_gf.gf8_bitmatrix(
        ref_gf.vandermonde_parity(4, 2)))).all()
    words = rng.integers(-(1 << 31), 1 << 31, (2 * N_CELLS, 32, 128),
                         dtype=np.int64).astype(np.int32)
    runs = xor_kernel.plain_runs
    out, total = mesh.distributed_xor_encode_step(pm, masks, words)
    rout, rtotal = ref_mesh.distributed_xor_encode_step(rm, masks, words)
    assert xor_kernel.plain_runs - runs == N_CELLS
    assert out.shape == (2 * N_CELLS, 16, 128)
    assert np.array_equal(out.numpy(), np.asarray(rout))
    assert np.array_equal(out.numpy(), np.asarray(
        xor_kernel.xor_matmul_w32(masks, words)))
    assert int(total) == int(rtotal) == int(words.astype(np.int64).sum())


def test_a_mesh_may_repeat_a_device():
    """The divergence: a mesh of four cells on one device.  The
    reference's plane refuses a mesh that repeats a device; the port's
    runs each cell's block on it and equals the unsharded kernel."""
    from ceph_tpu.parallel.data_plane import ShardedDataPlane as RefPlane
    from ceph_tpu_torch.parallel.data_plane import ShardedDataPlane
    rng = np.random.default_rng(2)
    masks = gf2.bitmatrix_masks(gf.gf8_bitmatrix(gf.vandermonde_parity(4, 2)))
    words = rng.integers(-(1 << 31), 1 << 31, (6, 32, 16),
                         dtype=np.int64).astype(np.int32)
    d0 = jax.devices()[0]
    with pytest.raises(AssertionError):
        RefPlane(ref_mesh.make_mesh(4, devices=[d0] * 4)).xor_matmul_w32(
            masks, words)
    for m in (mesh.make_mesh(4, devices=["cpu"] * 4),
              mesh.make_mesh_2d(2, 2, devices=["cpu"] * 4)):
        runs = xor_kernel.plain_runs
        dp = ShardedDataPlane(m)
        got = dp.xor_matmul_w32(masks, words)
        assert xor_kernel.plain_runs - runs == 4
        assert torch.equal(got, xor_kernel.xor_matmul_w32(masks, words))
