"""The port's fused ragged encode (ops/ragged_fused.py) and the host side
of kernel K3 against ceph_tpu.

The reference's Pallas kernel does not run on the CPU; the JAX package's
own tests hold ``ragged_fused.encode`` (its XLA route) to
``encode_padded`` and zlib, and so does this file, on the port's plain
version.  Every comparison is exact (GF(2^8) parity and crc32 have no
tolerance):

  * the port's ``encode`` and ``encode_padded`` equal the reference's
    ``encode`` and ``encode_padded`` — parity bytes and every Csums
    (block, subs, length, combined) — at 1-byte, exact-block and
    tail-block objects;
  * the crcs equal zlib row by row; the padding arithmetic and the
    ``unfused`` / ``device_tail`` scan counters match the reference's;
  * the port's ``fused_block_math`` (K3's plain version) equals the
    reference's at RS(4,2), RS(8,3) and a random bit-matrix;
  * a NumPy emulation of K3's crc walk (16-byte thread segments through
    the nibble slicing tables, the chunk roll, the lane and warp
    operators, the XOR folds) equals zlib at every block size class, so
    the tables the card reads are held here;
  * ``impl="pallas"`` on a CPU pool raises (the reference falls back
    to its XLA route; the port does not); ``impl="plane"`` with the
    data plane off runs the unsharded path, as the reference's does
    (the plane itself: tests/test_torch_data_plane.py).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.ops import gf as ref_gf
from ceph_tpu.ops import ragged_fused as ref_rf
from ceph_tpu_torch.common import crcutil
from ceph_tpu_torch.common.options import config
from ceph_tpu_torch.common.perf_counters import perf
from ceph_tpu_torch.ops import gf, gf_pallas, ragged_fused

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

K, M = 4, 2
SIZES = [1, 5, 700, 4096, 4097, 8192, 12289]


def _shards(rng, sizes, k=K):
    return [rng.integers(0, 256, (k, n), dtype=np.uint8) for n in sizes]


def _assert_identical(got, want):
    assert len(got.parity) == len(want.parity)
    for i, (gp, wp) in enumerate(zip(got.parity, want.parity)):
        gp, wp = np.asarray(gp), np.asarray(wp)
        assert gp.shape == wp.shape, i
        assert (gp == wp).all(), f"object {i}: parity bytes diverge"
    for name, gl, wl in (("data", got.data_csums, want.data_csums),
                         ("parity", got.parity_csums, want.parity_csums)):
        assert len(gl) == len(wl)
        for i, (grow, wrow) in enumerate(zip(gl, wl)):
            assert len(grow) == len(wrow)
            for j, (g, w) in enumerate(zip(grow, wrow)):
                assert (g.block, g.subs, g.length, g.combined) == \
                    (w.block, w.subs, w.length, w.combined), \
                    f"object {i} {name} row {j} csums diverge"


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(20)
    return gf.isa_rs_parity(K, M), _shards(rng, SIZES)


def test_parity_matrix_is_the_references(batch):
    A, _ = batch
    assert (A == ref_gf.isa_rs_parity(K, M)).all()


@pytest.mark.parametrize("fn", ["encode", "encode_padded"])
def test_port_equals_reference_encode(batch, fn):
    A, shards = batch
    want = ref_rf.encode(A, shards)
    got = getattr(ragged_fused, fn)(A, shards, device="cpu")
    _assert_identical(got, want)


def test_port_encode_equals_reference_padded(batch):
    A, shards = batch
    _assert_identical(ragged_fused.encode(A, shards, device="cpu"),
                      ref_rf.encode_padded(A, shards))


def test_fused_csums_match_zlib_oracle():
    rng = np.random.default_rng(21)
    A = gf.isa_rs_parity(K, M)
    shards = _shards(rng, [4097, 100, 8192])
    res = ragged_fused.encode(A, shards, device="cpu")
    T = ragged_fused.TILE
    for i, s in enumerate(shards):
        L = int(s.shape[1])
        for j in range(K):
            cs = res.data_csums[i][j]
            row = s[j].tobytes()
            assert cs.length == L and cs.block == T
            assert cs.subs == [zlib.crc32(row[o:o + T])
                               for o in range(0, L, T)]
            assert cs.combined == zlib.crc32(row)
        for j in range(M):
            cs = res.parity_csums[i][j]
            row = res.parity[i][j].tobytes()
            assert cs.subs == [zlib.crc32(row[o:o + T])
                               for o in range(0, L, T)]
            assert cs.combined == zlib.crc32(row)


@pytest.mark.parametrize("n", [1, ragged_fused.TILE, ragged_fused.TILE + 1])
def test_single_object_degenerate_batches(n):
    rng = np.random.default_rng(22 + n)
    A = gf.isa_rs_parity(K, M)
    shards = _shards(rng, [n])
    got = ragged_fused.encode(A, shards, device="cpu")
    _assert_identical(got, ragged_fused.encode_padded(A, shards,
                                                      device="cpu"))
    _assert_identical(got, ref_rf.encode(A, shards))


def test_padding_accounting_is_arithmetic():
    rng = np.random.default_rng(23)
    sizes = [1, 4096, 100_000, 257]
    shards = _shards(rng, sizes)
    b = ragged_fused.pack(shards)
    ref = ref_rf.pack(shards)
    T = b.tile
    rect = len(sizes) * (K + M) * max(sizes)
    fused = sum(-(-n // T) for n in sizes) * (K + M) * T
    assert b.rect_bytes(M) == rect == ref.rect_bytes(M)
    assert b.fused_bytes(M) == fused == ref.fused_bytes(M)
    assert b.padding_avoided(M) == rect - fused == ref.padding_avoided(M)
    assert b.padding_avoided(M) > 0
    assert (b.pool == ref.pool).all() and (b.desc == ref.desc).all()
    uni = ragged_fused.pack(_shards(rng, [T, T, T]))
    assert uni.padding_avoided(M) == 0


def test_pack_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="empty ragged batch"):
        ragged_fused.pack([])
    with pytest.raises(ValueError, match="empty object"):
        ragged_fused.pack([np.zeros((K, 0), np.uint8)])
    with pytest.raises(ValueError, match="want"):
        ragged_fused.pack([np.zeros((K, 3), np.uint8),
                           np.zeros((K + 1, 3), np.uint8)])


def test_unfused_comparator_pays_the_counted_scan():
    """encode_padded scans every data+parity row at ``unfused``; the
    fused path's host traffic is exactly the sub-tile tails."""
    rng = np.random.default_rng(24)
    A = gf.isa_rs_parity(K, M)
    shards = _shards(rng, [8192, 4097])
    pc = perf("wire.zero")
    u0 = pc.dump().get("scan_unfused_bytes", 0)
    t0 = pc.dump().get("scan_device_tail_bytes", 0)
    ragged_fused.encode_padded(A, shards, device="cpu")
    u1 = pc.dump().get("scan_unfused_bytes", 0)
    assert u1 - u0 == (K + M) * (8192 + 4097)
    ragged_fused.encode(A, shards, device="cpu")
    t1 = pc.dump().get("scan_device_tail_bytes", 0)
    assert pc.dump().get("scan_unfused_bytes", 0) == u1
    assert t1 - t0 == (K + M) * (4097 % ragged_fused.TILE)


def _ref_block_math(bitmat, pool):
    fn = ref_rf._jit_fused(pool.shape[2])
    par, dcrc, pcrc = fn(jnp.asarray(bitmat, jnp.int8),
                         jnp.asarray(pool, jnp.uint8))
    return (np.asarray(par), np.asarray(dcrc).astype(np.int64),
            np.asarray(pcrc).astype(np.int64))


@pytest.mark.parametrize("case", ["rs42", "rs83", "random"])
def test_fused_block_math_equals_reference(case):
    rng = np.random.default_rng({"rs42": 30, "rs83": 31, "random": 32}[case])
    if case == "random":
        k, m = 5, 6
        bitmat = rng.integers(0, 2, (8 * m, 8 * k), dtype=np.uint8)
    else:
        k, m = (4, 2) if case == "rs42" else (8, 3)
        bitmat = gf.gf8_bitmatrix(gf.isa_rs_parity(k, m))
    pool = rng.integers(0, 256, (3, k, 4096), dtype=np.uint8)
    A8, const = ragged_fused._crc_a8(4096)
    rA8, rconst = ref_rf._crc_a8(4096)
    assert const == rconst and (A8 == rA8).all()
    got = ragged_fused.fused_block_math(
        torch.from_numpy(bitmat), torch.from_numpy(A8), const,
        torch.from_numpy(pool))
    want = _ref_block_math(bitmat, pool)
    for g, w in zip(got, want):
        assert (g.numpy() == w).all()
    assert got[1][0, 0].item() == zlib.crc32(pool[0, 0].tobytes())


def test_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(33)
    bitmat = gf.gf8_bitmatrix(gf.isa_rs_parity(K, M))
    pool = torch.from_numpy(rng.integers(0, 256, (2, K, 512),
                                         dtype=np.uint8))
    n0, p0 = gf_pallas.fused_launches, gf_pallas.plain_runs
    par, dcrc, pcrc = gf_pallas.fused_ragged_matmul(bitmat, pool)
    assert gf_pallas.fused_launches == n0
    assert gf_pallas.plain_runs == p0 + 1
    want = _ref_block_math(bitmat, pool.numpy())
    assert (par.numpy() == want[0]).all()
    assert (dcrc.numpy() == want[1]).all() and (pcrc.numpy() == want[2]).all()
    assert dcrc.dtype == torch.int64


def test_wrapper_rejects_bad_inputs():
    bitmat = gf.gf8_bitmatrix(gf.isa_rs_parity(K, M))
    with pytest.raises(TypeError):
        gf_pallas.fused_ragged_matmul(bitmat, np.zeros((1, K, 8), np.uint8))
    with pytest.raises(TypeError):
        gf_pallas.fused_ragged_matmul(bitmat, torch.zeros((1, K, 8),
                                                          dtype=torch.int32))
    with pytest.raises(ValueError, match="does not contract"):
        gf_pallas.fused_ragged_matmul(bitmat, torch.zeros(
            (1, K + 1, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="pool must be"):
        gf_pallas.fused_ragged_matmul(bitmat, torch.zeros(
            (K, 8), dtype=torch.uint8))


# ------------------------------------------------ K3's crc walk, emulated --

def _k3_crc_emulated(row: bytes) -> int:
    """The kernel's crc of one T-byte row, step for step, from the tables
    the card reads: the row is zero-padded to whole chunks; thread t walks
    its 16 bytes of each chunk from 0 through the slicing tables (32
    nibble lookups), rolls its running crc over each later chunk
    (Z^chunk), carries it to the end of its warp's 512 bytes through its
    lane operator; the warp XORs its lanes, each warp's crc goes through
    its warp operator (to the padded end and back to T), the block XORs
    the warps and XORs in crc32(0^T)."""
    T = len(row)
    tabs = gf_pallas.crc_tables()
    sl = tabs[:512].reshape(16, 2, 16)
    lanes = tabs[512:512 + 4096].reshape(8, 16, 32)
    roll = tabs[512 + 4096:].reshape(8, 16)
    nthr, chunk = gf_pallas.K3_THREADS, gf_pallas.K3_CHUNK
    nc = -(-T // chunk)
    x = np.zeros(nc * chunk, dtype=np.uint8)
    x[:T] = np.frombuffer(row, dtype=np.uint8)
    x = x.reshape(nc, nthr, 16).astype(np.int64)
    i = np.arange(16)
    seg = np.bitwise_xor.reduce(sl[i, 0, x & 15] ^ sl[i, 1, x >> 4],
                                axis=-1)                    # [nc, nthr]

    def nibbles(v):
        return [(v >> (4 * j)) & 15 for j in range(8)]

    run = seg[0]
    for c in range(1, nc):
        rolled = np.zeros_like(run)
        for j, n in enumerate(nibbles(run)):
            rolled ^= roll[j, n]
        run = rolled ^ seg[c]
    lane = np.arange(nthr) % 32
    carried = np.zeros_like(run)
    for j, n in enumerate(nibbles(run)):
        carried ^= lanes[j, n, lane]
    warps = np.bitwise_xor.reduce(carried.reshape(gf_pallas.K3_WARPS, 32),
                                  axis=1)
    ops = gf_pallas.warp_operators(T)
    lin = 0
    for w, v in enumerate(warps.tolist()):
        for b in range(32):
            if (v >> b) & 1:
                lin ^= int(ops[b, w])
    return lin ^ zlib.crc32(bytes(T))


@pytest.mark.parametrize("T", [1, 3, 15, 16, 17, 64, 512, 600, 4095, 4096,
                               4097, 65536])
def test_kernel_walk_emulated_equals_zlib(T):
    rng = np.random.default_rng(40 + T)
    for _ in range(2):
        row = rng.integers(0, 256, T, dtype=np.uint8).tobytes()
        assert _k3_crc_emulated(row) == zlib.crc32(row)


def test_crc_tables_and_operators_are_zero_advances():
    """Every table entry is a zero advance of a byte's crc: Z^n v equals
    crcutil.crc32_combine(v, 0, n) (zlib's combine), for the slicing
    tables, the lane operators, the chunk roll and the warp operators
    (whose padding is undone: advancing a warp operator's image by the
    padding z gives the plain advance to the padded end)."""
    tabs = gf_pallas.crc_tables()
    assert tabs.dtype == np.uint32 and tabs.shape == (512 + 4096 + 128,)
    sl = tabs[:512].reshape(16, 2, 16)
    lanes = tabs[512:512 + 4096].reshape(8, 16, 32)
    roll = tabs[512 + 4096:].reshape(8, 16)
    rng = np.random.default_rng(41)
    z0 = zlib.crc32(b"\x00")
    for i, h, n in rng.integers(0, [16, 2, 16], size=(8, 3)).tolist():
        byte = zlib.crc32(bytes([n << (4 * h)])) ^ z0
        assert int(sl[i, h, n]) == crcutil.crc32_combine(byte, 0, 15 - i)
    for l in (0, 5, 30, 31):
        for j, n in ((0, 1), (3, 9), (7, 15)):
            assert int(lanes[j, n, l]) == crcutil.crc32_combine(
                n << (4 * j), 0, 16 * (31 - l))
    assert int(roll[2, 5]) == crcutil.crc32_combine(5 << 8, 0, 4096)
    for T in (4096, 4097, 600):
        ops = gf_pallas.warp_operators(T)
        z = -(-T // 4096) * 4096 - T
        for w in (0, 3, 7):
            for b in (0, 17, 31):
                assert crcutil.crc32_combine(int(ops[b, w]), 0, z) == \
                    crcutil.crc32_combine(1 << b, 0, 512 * (7 - w))
    assert int(gf_pallas.warp_operators(4096)[4, 7]) == 1 << 4


def test_nibble_tables_split_the_byte_tables():
    bm = gf.gf8_bitmatrix(gf.isa_rs_parity(5, 6))
    packed = gf_pallas.pack_tables(gf_pallas.tables_host(bm))
    nib = gf_pallas.nibble_tables(bm)
    assert nib.shape == (2, 5, 32) and nib.dtype == np.uint32
    v = np.arange(256)
    assert (nib[..., v & 15] ^ nib[..., 16 + (v >> 4)] == packed).all()


def test_crc_leg_and_crc32_blocks_on_the_cpu_keep_their_contracts():
    """``crc_leg`` gives [N] int64 crcs through the plain version on a CPU
    tensor; ``crc32_blocks`` returns a uint32 NumPy array [N] for a host
    array and for a tensor alike."""
    from ceph_tpu_torch.ops import crc32_gf2
    rng = np.random.default_rng(42)
    blocks = rng.integers(0, 256, (5, 4096), dtype=np.uint8)
    want = [zlib.crc32(r.tobytes()) for r in blocks]
    p0 = gf_pallas.plain_runs
    got = gf_pallas.crc_leg(torch.from_numpy(blocks))
    assert gf_pallas.plain_runs == p0 + 1
    assert got.dtype == torch.int64 and got.tolist() == want
    for arg in (blocks, torch.from_numpy(blocks)):
        out = crc32_gf2.crc32_blocks(arg, device="cpu")
        assert isinstance(out, np.ndarray) and out.dtype == np.uint32
        assert out.shape == (5,) and out.tolist() == want


# ------------------------------------------------------ the divergences --

def test_pallas_and_plane_raise_on_the_cpu():
    """The reference runs ``impl="pallas"`` off-TPU through its XLA
    route; the port has no fallback (ROADMAP section C).  ``impl="plane"``
    with the plane off, or on with one cell (the CPU's default), takes
    the unsharded path in both packages; the plane's own cases are in
    tests/test_torch_data_plane.py."""
    rng = np.random.default_rng(27)
    A = gf.isa_rs_parity(K, M)
    shards = _shards(rng, [4097])
    with pytest.raises(ValueError, match="CUDA pool"):
        ragged_fused.encode(A, shards, impl="pallas", device="cpu")
    want = ref_rf.encode_padded(A, shards)
    _assert_identical(ragged_fused.encode(A, shards, impl="plane",
                                          device="cpu"), want)
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    config().set("parallel_data_plane", True)
    try:
        _assert_identical(ragged_fused.encode(A, shards, impl="plane"),
                          want)
    finally:
        config().clear("parallel_data_plane")
        ceph_tpu_torch.set_default_device(prev)
    with pytest.raises(ValueError, match="unknown impl"):
        ragged_fused.encode(A, shards, impl="tpu", device="cpu")
    _assert_identical(ragged_fused.encode(A, shards, impl="xla",
                                          device="cpu"),
                      ref_rf.encode_padded(A, shards))


def test_encode_without_a_card_raises_unless_the_cpu_is_asked():
    import ceph_tpu_torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    A = gf.isa_rs_parity(K, M)
    shards = _shards(np.random.default_rng(29), [10])
    assert ceph_tpu_torch.default_device() == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ragged_fused.encode(A, shards)


def test_zipf_profile_fused_wins_padding():
    """The S3Serve mixed-size shape (the reference bench's profile):
    the padded rectangle pays for the largest object on every row."""
    rng = np.random.default_rng(28)
    sizes = np.clip((rng.zipf(1.3, 32).astype(float) * 512
                     ).astype(np.int64), 1, 256 << 10).tolist()
    shards = _shards(rng, sizes)
    b = ragged_fused.pack(shards)
    assert b.padding_avoided(M) == b.rect_bytes(M) - b.fused_bytes(M)
    assert b.padding_avoided(M) == ref_rf.pack(shards).padding_avoided(M)
    if len(set(sizes)) > 1:
        assert b.padding_avoided(M) > 0
