"""The port on the card: kernels K1, K2 and K3 against their plain
PyTorch versions, the fast mapper, the cluster step and the fused ragged
encode against the CPU, and the wire's receive verify on the card.

Every test here needs an NVIDIA card and skips without one (the decision
is made inside a fixture, never at import).  Run on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py

The file imports no JAX: its NumPy oracle is ceph_tpu/ops/gf2.py, which
is NumPy-only, and zlib for crc32.  GF(2) arithmetic and crc32: every
comparison is exact.
"""
import time
import zlib

import numpy as np
import pytest
import torch

from ceph_tpu.ops import gf2 as gf2_ref
from ceph_tpu_torch.ec import instance
from ceph_tpu_torch.ops import gf, gf2, gf_jax, gf_pallas, xor_kernel
from test_torch_powercycle import PC_CFG, kill_windows, seeded_schedule

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (K1 has no CPU mode)")
    return torch.device("cuda")


def rand_words(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, size=shape,
                        dtype=np.int64).astype(np.int32)


def rand_masks(shape, seed):
    rng = np.random.default_rng(seed)
    return -rng.integers(0, 2, size=shape, dtype=np.int64).astype(np.int32)


def decode_masks(k, m, erased):
    G = gf.generator_matrix(gf.vandermonde_parity(k, m))
    avail = [c for c in range(k + m) if c not in erased][:k]
    R = gf.gf_matmul(G[sorted(erased)], gf.gf_gaussian_inverse(G[avail]))
    return gf2.bitmatrix_masks(gf.gf8_bitmatrix(R))


def rebuild_masks(B, k, m, seed):
    """[B, 8m, 8(k+m)] full-width masks, one erasure signature each."""
    rng = np.random.default_rng(seed)
    n = k + m
    out = np.zeros((B, 8 * m, 8 * n), dtype=np.int32)
    for b in range(B):
        lost = sorted(rng.choice(n, size=int(rng.integers(1, m + 1)),
                                 replace=False).tolist())
        avail = [c for c in range(n) if c not in lost][:k]
        small = decode_masks(k, m, lost)
        for jj, c in enumerate(avail):
            out[b, :8 * len(lost), 8 * c:8 * c + 8] = \
                small[:, 8 * jj:8 * jj + 8]
    return out


def check(card, masks_np, words_np):
    """Kernel == plain version (on the card) == plain version on the
    CPU; returns the kernel's output on the host."""
    masks = torch.from_numpy(masks_np).to(card)
    words = torch.from_numpy(words_np).to(card)
    got = xor_kernel.xor_matmul_w32(masks, words)
    torch.cuda.synchronize()
    lead = words_np.shape[:-2]
    m3 = masks.reshape(-1, *masks.shape[-2:])
    w3 = words.reshape(-1, *words.shape[-2:])
    plain = xor_kernel._combine_torch(m3, w3).reshape(got.shape)
    assert torch.equal(got, plain)
    cpu = xor_kernel._combine_torch(m3.cpu(), w3.cpu()).reshape(got.shape)
    out = got.cpu()
    assert torch.equal(out, cpu)
    assert out.shape == lead + (masks_np.shape[-2], words_np.shape[-1])
    return out.numpy()


MAIN_SHAPES = {
    "encode": (lambda: gf2.bitmatrix_masks(
        gf.gf8_bitmatrix(gf.vandermonde_parity(8, 3))), (64, 64, 4096)),
    "decode": (lambda: decode_masks(8, 3, [1, 4, 9]), (32, 64, 4096)),
    "rebuild": (lambda: rebuild_masks(64, 8, 3, 5), (64, 88, 4096)),
    "ragged": (lambda: gf2.bitmatrix_masks(
        gf.gf8_bitmatrix(gf.vandermonde_parity(8, 3))), (8, 64, 4095)),
}


@pytest.mark.parametrize("shape", sorted(MAIN_SHAPES))
def test_kernel_matches_plain_at_main_path_shapes(card, shape):
    mk, wshape = MAIN_SHAPES[shape]
    check(card, mk(), rand_words(wshape, 1))


@pytest.mark.parametrize("W", [1, 3, 5, 127, 130, 513, 4097])
def test_ragged_word_counts(card, W):
    masks = gf2.bitmatrix_masks(gf.gf8_bitmatrix(gf.isa_cauchy_parity(4, 2)))
    check(card, masks, rand_words((3, 32, W), W))


@pytest.mark.parametrize("R", [1, 3, 8, 17, 24, 32, 33, 40, 64, 72])
def test_row_groups(card, R):
    """R > 32 loops over register groups of rows; R below a group pads
    with zero mask rows."""
    check(card, rand_masks((R, 64), R), rand_words((4, 64, 1000), R))
    check(card, rand_masks((2, R, 16), R + 1), rand_words((2, 16, 999), R))


def test_matches_reference_oracle(card):
    B = gf.gf8_bitmatrix(gf.cauchy_good_parity(8, 3))
    words = rand_words((4, 64, 256), 7)
    out = check(card, gf2.bitmatrix_masks(B), words)
    planes = words.view(np.uint8).reshape(4, 64, 1024)
    assert np.array_equal(out.view(np.uint8).reshape(4, 24, 1024),
                          gf2_ref.region_xor_matmul_np(B, planes))


def test_misaligned_words_take_the_scalar_path(card):
    masks = torch.from_numpy(rand_masks((24, 64), 2)).to(card)
    flat = torch.from_numpy(rand_words((1 + 2 * 64 * 256,), 3)).to(card)
    words = flat[1:].view(2, 64, 256)        # contiguous, 4 B off 16 B
    assert words.is_contiguous() and words.data_ptr() % 16
    got = xor_kernel.xor_matmul_w32(masks, words)
    assert torch.equal(got, xor_kernel._combine_torch(masks[None], words))


def test_wrong_inputs_raise(card):
    masks = torch.zeros((24, 64), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        xor_kernel.xor_matmul_w32(
            masks, torch.zeros((2, 64, 8), dtype=torch.int64, device=card))
    with pytest.raises(ValueError, match="masks on"):
        xor_kernel.xor_matmul_w32(
            masks.cpu(), torch.zeros((2, 64, 8), dtype=torch.int32,
                                     device=card))
    with pytest.raises(ValueError, match="mask batch"):
        xor_kernel.xor_matmul_w32(
            torch.zeros((3, 24, 64), dtype=torch.int32, device=card),
            torch.zeros((2, 64, 8), dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="columns"):
        xor_kernel.xor_matmul_w32(
            masks, torch.zeros((2, 32, 8), dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        xor_kernel.xor_matmul_w32(
            masks, torch.zeros((2, 64, 16), dtype=torch.int32,
                               device=card)[:, :, ::2])
    with pytest.raises(ValueError, match="shared memory"):
        xor_kernel.xor_matmul_w32(
            torch.zeros((32, 400), dtype=torch.int32, device=card),
            torch.zeros((1, 400, 8), dtype=torch.int32, device=card))


def test_cuda_tensor_never_reaches_plain_version(card, monkeypatch):
    def refuse(*_):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(xor_kernel, "_combine_torch", refuse)
    runs, launches = xor_kernel.plain_runs, xor_kernel.launches
    masks = torch.from_numpy(rand_masks((24, 64), 4)).to(card)
    xor_kernel.xor_matmul_w32(masks, torch.from_numpy(
        rand_words((2, 64, 64), 4)).to(card))
    torch.cuda.synchronize()
    assert xor_kernel.plain_runs == runs
    assert xor_kernel.launches == launches + 1


def test_codec_on_card_equals_codec_on_cpu(card):
    prof = {"k": "8", "m": "3", "layout": "bitsliced"}
    gpu = instance().factory("jax", prof, device=card)
    cpu = instance().factory("jax", prof, device="cpu")
    data = np.random.default_rng(9).integers(0, 256, size=(4, 8, 4096),
                                             dtype=np.uint8)
    par = gpu.encode_chunks_batch(data)
    assert np.array_equal(par, cpu.encode_chunks_batch(data))
    full = np.concatenate([data, par], axis=1)
    avail = [0, 2, 3, 5, 6, 7, 8, 10]
    assert np.array_equal(
        gpu.decode_chunks_batch(avail, full[:, avail], [1, 4, 9]),
        full[:, [1, 4, 9]])


# ------------------------------------------------------------------ K2 --

def check_k2(card, bitmat, data_np, data=None):
    """K2 == its plain version on the card == the plain version on the
    CPU (exact)."""
    if data is None:
        data = torch.from_numpy(data_np).to(card)
    got = gf_pallas.bitplane_matmul(bitmat, data)
    plain = gf_jax.bitplane_matmul(torch.as_tensor(bitmat, device=card),
                                   data)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    cpu = gf_jax.bitplane_matmul(torch.as_tensor(bitmat),
                                 data.cpu())
    assert torch.equal(got.cpu(), cpu)
    return got


def rand_bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


def decode_bitmat(k, m, erased):
    G = gf.generator_matrix(gf.vandermonde_parity(k, m))
    avail = [c for c in range(k + m) if c not in erased][:k]
    return gf.gf8_bitmatrix(
        gf.gf_matmul(G[sorted(erased)], gf.gf_gaussian_inverse(G[avail])))


@pytest.mark.parametrize("name,shape,rows", [
    ("put", (4, 8, 131072), "encode"),
    ("decode", (4, 8, 131072), "decode"),
    ("recovery", (32, 8, 131072), "decode"),
    ("ragged", (4, 8, 131071), "encode"),
    ("tiny", (3, 8, 13), "encode"),
])
def test_k2_matches_plain_at_main_path_shapes(card, name, shape, rows):
    bitmat = gf.gf8_bitmatrix(gf.vandermonde_parity(8, 3)) \
        if rows == "encode" else decode_bitmat(8, 3, [1, 4, 9])
    got = check_k2(card, bitmat, rand_bytes(shape, len(name)))
    assert tuple(got.shape) == shape[:1] + (3,) + shape[2:]


def test_k2_unaligned_pointer(card):
    bitmat = gf.gf8_bitmatrix(gf.cauchy_good_parity(6, 3))
    flat = torch.from_numpy(rand_bytes(2 * 6 * 4096 + 1, 8)).to(card)
    data = flat[1:].reshape(2, 6, 4096)       # 1-byte offset: byte loads
    assert data.data_ptr() % 16 == 1
    check_k2(card, bitmat, None, data)


def test_k2_twenty_chunks_and_random_bitmatrices(card):
    """k + m = 20 (two row groups of four), and a random bit-matrix of 20
    output rows (two passes) — the table form holds for any bitmat."""
    check_k2(card, gf.gf8_bitmatrix(gf.isa_rs_parity(14, 6)),
             rand_bytes((3, 14, 4096), 9))
    bm = np.random.default_rng(10).integers(0, 2, size=(160, 72),
                                            dtype=np.uint8)
    check_k2(card, bm, rand_bytes((3, 9, 1001), 11))


@pytest.mark.parametrize("shape", [
    (1, 8, 4096),          # 4 blocks: far under one wave
    (4, 8, 131072),        # the put: 512 blocks of 8 bytes a thread
    (40, 8, 131072),       # 2,560 blocks of 16 bytes a thread
    (128, 8, 131072),      # 8,192 blocks: many waves
])
def test_k2_grids_under_one_wave_and_over_several(card, shape):
    bitmat = gf.gf8_bitmatrix(gf.vandermonde_parity(8, 3))
    check_k2(card, bitmat, rand_bytes(shape, shape[0]))


@pytest.mark.parametrize("k", [1, 32])
@pytest.mark.parametrize("m", range(1, 21))
def test_k2_every_row_count_up_to_twenty(card, m, k):
    """Single, paired and paired + single row groups, two passes from
    m = 17, one to four row batches, on random bit-matrices."""
    rng = np.random.default_rng(100 * m + k)
    bm = rng.integers(0, 2, size=(8 * m, 8 * k), dtype=np.uint8)
    check_k2(card, bm, rng.integers(0, 256, size=(2, k, 4097),
                                    dtype=np.uint8))


@pytest.mark.parametrize("L", [1, 15, 16, 17, 4095, 4097])
@pytest.mark.parametrize("offset", [0, 1])
def test_k2_column_edges_and_unaligned_data(card, L, offset):
    bm = np.random.default_rng(L).integers(0, 2, size=(40, 160),
                                           dtype=np.uint8)
    n = 3 * 20 * L
    flat = torch.from_numpy(rand_bytes(n + offset, L + offset)).to(card)
    data = flat[offset:].view(3, 20, L)
    assert data.data_ptr() % 16 == offset
    check_k2(card, bm, None, data)


def test_k2_captured_in_a_cuda_graph_equals_eager(card):
    """K2 calls captured into a CUDA graph (the put and a wide random
    bit-matrix) replay to the eager outputs and re-read their input on
    every replay."""
    enc = gf.gf8_bitmatrix(gf.vandermonde_parity(8, 3))
    wide = np.random.default_rng(24).integers(0, 2, size=(160, 256),
                                              dtype=np.uint8)
    put = torch.from_numpy(rand_bytes((4, 8, 131072), 25)).to(card)
    other = torch.from_numpy(rand_bytes((3, 32, 4097), 26)).to(card)

    def call():
        return (gf_pallas.bitplane_matmul(enc, put),
                gf_pallas.bitplane_matmul(wide, other))
    call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = call()
    for new_seed in (None, 27):
        if new_seed is not None:
            put.copy_(torch.from_numpy(rand_bytes((4, 8, 131072),
                                                  new_seed)))
            other.copy_(torch.from_numpy(rand_bytes((3, 32, 4097),
                                                    new_seed + 1)))
        g.replay()
        eager = call()
        torch.cuda.synchronize()
        for c, e in zip(captured, eager):
            assert torch.equal(c, e)
    assert torch.equal(captured[0].cpu(), gf_jax.bitplane_matmul(
        torch.as_tensor(enc), put.cpu()))


@pytest.mark.parametrize("shape,m", [
    ((4, 8, 131072), 3), ((128, 8, 131072), 3), ((3, 32, 4097), 20),
    ((2, 20, 1), 17), ((1, 1, 13), 1), ((3, 200, 4096), 4),
])
def test_k2_floor_refuses_nothing_k2_accepts(card, shape, m):
    """The launch floor takes every shape K2 takes, launches, and counts
    no K2 launch."""
    bm = np.random.default_rng(m).integers(0, 2, size=(8 * m, 8 * shape[1]),
                                           dtype=np.uint8)
    data = torch.from_numpy(rand_bytes(shape, m)).to(card)
    check_k2(card, bm, None, data)
    launches = gf_pallas.launches
    gf_pallas.bitplane_floor(m, data)
    torch.cuda.synchronize()
    assert gf_pallas.launches == launches


def test_k2_wrong_inputs_raise(card):
    bitmat = gf.gf8_bitmatrix(gf.vandermonde_parity(4, 2))
    with pytest.raises(TypeError):
        gf_pallas.bitplane_matmul(
            bitmat, torch.zeros((1, 4, 64), dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="contract"):
        gf_pallas.bitplane_matmul(
            bitmat, torch.zeros((1, 3, 64), dtype=torch.uint8, device=card))
    with pytest.raises(ValueError, match="contract"):
        gf_pallas.bitplane_matmul(bitmat[:, :24], torch.zeros(
            (1, 4, 64), dtype=torch.uint8, device=card))
    for lead in ((1,), (2, 3)):
        with pytest.raises(ValueError, match="contiguous"):
            gf_pallas.bitplane_matmul(bitmat, torch.zeros(
                lead + (64, 4), dtype=torch.uint8,
                device=card).transpose(-1, -2))


def test_k2_cuda_tensor_never_reaches_plain_version(card, monkeypatch):
    def refuse(*_):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(gf_pallas, "_bitplane_matmul_torch", refuse)
    runs, launches = gf_pallas.plain_runs, gf_pallas.launches
    gf_pallas.bitplane_matmul(gf.gf8_bitmatrix(gf.vandermonde_parity(8, 3)),
                              torch.from_numpy(rand_bytes((2, 8, 256), 12))
                              .to(card))
    torch.cuda.synchronize()
    assert gf_pallas.plain_runs == runs
    assert gf_pallas.launches == launches + 1


def test_byte_codec_on_card_equals_cpu_and_refuses_xla(card):
    from ceph_tpu_torch.common.options import config
    from ceph_tpu_torch.ec.interface import ErasureCodeError
    prof = {"k": "8", "m": "3", "layout": "bytes", "technique": "cauchy"}
    gpu = instance().factory("jax", prof, device=card)
    cpu = instance().factory("jax", prof, device="cpu")
    data = rand_bytes((4, 8, 4096), 13)
    par = gpu.encode_chunks_batch(data)
    assert np.array_equal(par, cpu.encode_chunks_batch(data))
    full = np.concatenate([data, par], axis=1)
    avail = [0, 2, 3, 5, 6, 7, 8, 10]
    assert np.array_equal(
        gpu.decode_chunks_batch(avail, full[:, avail], [1, 4, 9]),
        full[:, [1, 4, 9]])
    config().set("ec_kernel", "xla")
    try:
        with pytest.raises(ErasureCodeError, match="never runs"):
            gpu.encode_chunks_batch(data)
    finally:
        config().clear("ec_kernel")


# ------------------------------------------------ placement and cluster --

def test_fast_mapper_on_card_equals_cpu(card):
    from ceph_tpu_torch.placement.builder import TYPE_HOST, build_flat_cluster
    from ceph_tpu_torch.placement.crush_map import (
        RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP, RULE_EMIT, RULE_TAKE,
        Rule)
    from ceph_tpu_torch.placement.fast_mapper import FastMapper
    xs = np.arange(50000)
    for op, rm in ((RULE_CHOOSELEAF_FIRSTN, 3), (RULE_CHOOSELEAF_INDEP, 6)):
        cmap, root = build_flat_cluster(n_hosts=16, osds_per_host=4, seed=2)
        cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0), (op, 0, TYPE_HOST),
                                  (RULE_EMIT, 0, 0)]))
        w = [0x10000] * cmap.max_devices
        w[3], w[17] = 0, 0x8000
        a = FastMapper(cmap, device=card).map_batch(0, xs, rm, w)
        b = FastMapper(cmap, device="cpu").map_batch(0, xs, rm, w)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("layout", ["bitsliced", "bytes"])
def test_cluster_step_on_card_equals_cpu(card, layout):
    from ceph_tpu_torch import entry
    got = entry.cluster_step(device=card, layout=layout)
    want = entry.cluster_step(device="cpu", layout=layout)
    assert got["gets"] == got["datas"] == want["datas"]
    for key in ("placed", "gets2", "rec", "up0", "up1", "victims"):
        assert got[key] == want[key], key


# ------------------------------------------------------------------ K3 --

def check_k3(card, bitmat, pool):
    """K3 == its plain version on the card == zlib on the host (exact)."""
    from ceph_tpu_torch.ops import ragged_fused
    got = gf_pallas.fused_ragged_matmul(bitmat, pool)
    A8, const = ragged_fused._crc_a8(pool.shape[2])
    want = ragged_fused.fused_block_math(
        torch.as_tensor(bitmat, device=card), torch.as_tensor(A8),
        const, pool)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    host = pool.cpu().numpy()
    par = got[0].cpu().numpy()
    for g in (0, host.shape[0] - 1):
        assert got[1][g].tolist() == [zlib.crc32(r.tobytes())
                                      for r in host[g]]
        assert got[2][g].tolist() == [zlib.crc32(r.tobytes())
                                      for r in par[g]]
    return got


@pytest.mark.parametrize("name,k,m,G,T", [
    ("rs42_chunk", 4, 2, 512, 4096),
    ("rs83", 8, 3, 64, 4096),
    ("k14m6", 14, 6, 9, 4096),
    ("k4m16", 4, 16, 9, 4096),
    ("ragged_T", 4, 2, 7, 4095),
    ("rs42_513", 4, 2, 513, 4096),
    ("rs42_grid_stride", 4, 2, 4099, 4096),
])
def test_k3_matches_plain(card, name, k, m, G, T):
    A = gf.isa_rs_parity(k, m)
    pool = torch.from_numpy(rand_bytes((G, k, T), len(name))).to(card)
    check_k3(card, gf.gf8_bitmatrix(A), pool)


def test_k3_random_twenty_row_bitmatrix(card):
    bm = np.random.default_rng(14).integers(0, 2, size=(96, 64),
                                            dtype=np.uint8)
    check_k3(card, bm, torch.from_numpy(rand_bytes((33, 8, 4096), 15))
             .to(card))


def test_k3_unaligned_pool(card):
    flat = torch.from_numpy(rand_bytes(5 * 4 * 4096 + 1, 16)).to(card)
    pool = flat[1:].view(5, 4, 4096)
    assert pool.data_ptr() % 16 == 1
    check_k3(card, gf.gf8_bitmatrix(gf.isa_rs_parity(4, 2)), pool)


@pytest.mark.parametrize("T", [1, 3, 64, 512, 4095, 4096, 4097, 65536,
                               1 << 20])
def test_k3_crc_leg_every_block_size(card, T):
    """m = 0: the wire's crc at every block size (no size is refused)."""
    from ceph_tpu_torch.ops import crc32_gf2
    blocks = torch.from_numpy(rand_bytes((3 if T > 65536 else 40, T), T)) \
        .to(card)
    launches = gf_pallas.fused_launches
    got = crc32_gf2.crc32_blocks(blocks, block=T)
    assert gf_pallas.fused_launches == launches + 1
    want = [zlib.crc32(r.tobytes()) for r in blocks.cpu().numpy()]
    assert got.tolist() == want
    if T <= 4097:
        assert crc32_gf2.crc32_blocks_plain(blocks).tolist() == want


@pytest.mark.parametrize("N", [1, 70, 512])
def test_k3_crc_leg_at_frame_sizes(card, N):
    """The receive verify's shapes: N blocks of 4 KiB, one launch, equal
    to zlib and to the plain version."""
    from ceph_tpu_torch.ops import crc32_gf2
    blocks = torch.from_numpy(rand_bytes((N, 4096), 100 + N)).to(card)
    launches = gf_pallas.fused_launches
    got = gf_pallas.crc_leg(blocks)
    torch.cuda.synchronize()
    assert gf_pallas.fused_launches == launches + 1
    want = [zlib.crc32(r.tobytes()) for r in blocks.cpu().numpy()]
    assert got.dtype == torch.int64 and got.tolist() == want
    assert crc32_gf2.crc32_blocks_plain(blocks).tolist() == want
    out = crc32_gf2.crc32_blocks(blocks)
    assert out.dtype == np.uint32 and out.tolist() == want


def test_k3_captured_in_a_cuda_graph_equals_eager(card):
    """A K3 call captured into a CUDA graph (fused encode and crc leg)
    replays to the eager call's parity and crcs, and re-reads its input
    on every replay."""
    bm = gf.gf8_bitmatrix(gf.isa_rs_parity(4, 2))
    pool = torch.from_numpy(rand_bytes((600, 4, 4096), 21)).to(card)
    frame = torch.from_numpy(rand_bytes((70, 4096), 22)).to(card)

    def call():
        return gf_pallas.fused_ragged_matmul(bm, pool) + \
            (gf_pallas.crc_leg(frame),)
    call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = call()
    for new_seed in (None, 23):
        if new_seed is not None:
            pool.copy_(torch.from_numpy(rand_bytes((600, 4, 4096),
                                                   new_seed)))
            frame.copy_(torch.from_numpy(rand_bytes((70, 4096),
                                                    new_seed + 1)))
        g.replay()
        eager = call()
        torch.cuda.synchronize()
        for c, e in zip(captured, eager):
            assert c.dtype == e.dtype and torch.equal(c, e)
    assert captured[3].tolist() == [zlib.crc32(r.tobytes())
                                    for r in frame.cpu().numpy()]


def test_k3_object_edges_on_card_equal_cpu(card):
    from ceph_tpu_torch.ops import ragged_fused
    A = gf.isa_rs_parity(4, 2)
    rng = np.random.default_rng(17)
    shards = [rng.integers(0, 256, (4, n), dtype=np.uint8)
              for n in (1, 4096, 4097, 12289)]
    got = ragged_fused.encode(A, shards, device=card)
    want = ragged_fused.encode(A, shards, device="cpu")
    for i in range(len(shards)):
        assert np.array_equal(got.parity[i], want.parity[i])
        for g, w in zip(got.data_csums[i] + got.parity_csums[i],
                        want.data_csums[i] + want.parity_csums[i]):
            assert (g.block, g.subs, g.length, g.combined) == \
                (w.block, w.subs, w.length, w.combined)


def test_k3_wrong_inputs_raise(card):
    bitmat = gf.gf8_bitmatrix(gf.isa_rs_parity(4, 2))
    with pytest.raises(TypeError):
        gf_pallas.fused_ragged_matmul(
            bitmat, torch.zeros((1, 4, 64), dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="contract"):
        gf_pallas.fused_ragged_matmul(
            bitmat, torch.zeros((1, 3, 64), dtype=torch.uint8, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        gf_pallas.fused_ragged_matmul(bitmat, torch.zeros(
            (1, 64, 4), dtype=torch.uint8, device=card).transpose(-1, -2))
    from ceph_tpu_torch.ops import ragged_fused
    with pytest.raises(ValueError, match="CPU pool only"):
        ragged_fused.encode(gf.isa_rs_parity(4, 2),
                            [np.zeros((4, 9), np.uint8)], impl="xla",
                            device=card)


def test_k3_cuda_tensor_never_reaches_plain_version(card, monkeypatch):
    from ceph_tpu_torch.ops import crc32_gf2, ragged_fused

    def refuse(*_):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(ragged_fused, "fused_block_math", refuse)
    monkeypatch.setattr(crc32_gf2, "crc32_blocks_plain", refuse)
    runs, launches = gf_pallas.plain_runs, gf_pallas.fused_launches
    crc_runs = crc32_gf2.plain_runs
    ragged_fused.encode(gf.isa_rs_parity(4, 2),
                        [rand_bytes((4, 9000), 18)], device=card)
    crc32_gf2.crc32_blocks(rand_bytes((4, 4096), 19), device=card)
    torch.cuda.synchronize()
    assert gf_pallas.plain_runs == runs and crc32_gf2.plain_runs == crc_runs
    assert gf_pallas.fused_launches == launches + 2


def test_receive_verify_auto_runs_k3_on_the_card(card):
    import ceph_tpu_torch
    from ceph_tpu_torch.common import crcutil
    from ceph_tpu_torch.common.perf_counters import perf
    from ceph_tpu_torch.msg import wire
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cuda")
    try:
        data = rand_bytes(5 * 4096 + 3, 20).tobytes()
        launches = gf_pallas.fused_launches
        z0 = perf("wire.zero").dump()
        cs = wire.receive_csums(memoryview(data))
        z1 = perf("wire.zero").dump()
    finally:
        ceph_tpu_torch.set_default_device(prev)
    assert gf_pallas.fused_launches == launches + 1
    assert z1.get("device_crc_bytes", 0) - z0.get("device_crc_bytes", 0) \
        == 5 * 4096
    assert z1.get("scan_verify_bytes", 0) == z0.get("scan_verify_bytes", 0)
    want = crcutil.Csums.scan(data, site="test")
    assert (cs.subs, cs.combined) == (want.subs, want.combined)


# ------------------------------------------ the erasure-code plugins --

@pytest.mark.parametrize("technique,k,w", [
    ("liberation", 5, 7), ("blaum_roth", 6, 6), ("liber8tion", 6, 8)])
def test_bitmatrix_codec_on_card_runs_k1_and_equals_cpu(card, technique,
                                                         k, w):
    """The jerasure bitmatrix techniques' batch paths launch K1 once per
    dispatch on the card and equal the plain version on the CPU, at plane
    lengths that are not multiples of 8 words (w = 6, 7)."""
    prof = {"technique": technique, "k": str(k), "m": "2", "w": str(w)}
    gpu = instance().factory("jerasure", prof, device=card)
    cpu = instance().factory("jerasure", prof, device="cpu")
    assert gpu.device.type == "cuda"
    chunk = gpu.get_chunk_size(k * 131072)
    data = rand_bytes((4, k, chunk), 60)
    runs, launches = xor_kernel.plain_runs, xor_kernel.launches
    par = gpu.encode_chunks_batch(data)
    full = np.concatenate([data, par], axis=1)
    n = k + 2
    sets = [[0], [k], [1, k + 1], [0, k - 1]]
    for erased in sets:
        avail = [c for c in range(n) if c not in erased]
        assert np.array_equal(
            gpu.decode_chunks_batch(avail, full[:, avail], erased),
            full[:, erased])
    assert xor_kernel.plain_runs == runs
    assert xor_kernel.launches == launches + 1 + len(sets)
    assert np.array_equal(par, cpu.encode_chunks_batch(data))
    assert np.array_equal(par[0], cpu.encode_chunks(data[0]))


def test_clay_repair_on_card_runs_k2_and_equals_cpu(card):
    """CLAY(8,4,11): encode and the single-loss repair from d helpers on
    the card (each PFT solve and per-plane MDS decode one K2 launch)
    equal the CPU's, and no plain version runs."""
    prof = {"k": "8", "m": "4", "d": "11"}
    gpu = instance().factory("clay", prof, device=card)
    cpu = instance().factory("clay", prof, device="cpu")
    assert gpu.mds.device == gpu.pft.device == gpu.device
    chunk = gpu.get_chunk_size(8 * 131072)
    sub = gpu.get_sub_chunk_count()
    sc = chunk // sub
    data = rand_bytes((8, chunk), 61)
    runs, launches = gf_pallas.plain_runs, gf_pallas.launches
    par = gpu.encode_chunks(data)
    full = np.concatenate([data, par])
    lost = 3
    plan = gpu.minimum_to_decode({lost}, set(range(12)) - {lost})
    helpers = {h: np.concatenate([full[h].reshape(sub, sc)[o:o + c]
                                  for o, c in rg]).reshape(-1)
               for h, rg in plan.items()}
    got = gpu.repair(lost, helpers, chunk)
    assert gf_pallas.plain_runs == runs
    assert gf_pallas.launches > launches
    assert np.array_equal(got, full[lost])
    assert np.array_equal(par, cpu.encode_chunks(data))
    assert np.array_equal(got, cpu.repair(lost, helpers, chunk))


@pytest.mark.parametrize("plugin,prof", [
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("clay", {"k": "4", "m": "2", "d": "5"})])
def test_layered_inner_codecs_follow_the_outer_device(card, plugin, prof):
    """A layered codec builds its inner codecs on its own device, whatever
    the package default; under ``ec_kernel=xla`` a layered codec on the
    card raises through its inner codec."""
    import ceph_tpu_torch
    from ceph_tpu_torch.common.options import config
    from ceph_tpu_torch.ec.interface import ErasureCodeError

    def inner(codec):
        return [lay.codec for lay in codec.layers] if plugin == "lrc" \
            else [codec.mds, codec.pft]

    prev = ceph_tpu_torch.default_device()
    try:
        ceph_tpu_torch.set_default_device("cuda")
        cpu = instance().factory(plugin, dict(prof), device="cpu")
        ceph_tpu_torch.set_default_device("cpu")
        gpu = instance().factory(plugin, dict(prof), device=card)
    finally:
        ceph_tpu_torch.set_default_device(prev)
    assert {c.device.type for c in inner(cpu)} == {"cpu"}
    assert {c.device.type for c in inner(gpu)} == {"cuda"}
    data = rand_bytes((4, gpu.get_chunk_size(4 * 8192)), 62)
    assert np.array_equal(gpu.encode_chunks(data), cpu.encode_chunks(data))
    config().set("ec_kernel", "xla")
    try:
        with pytest.raises(ErasureCodeError, match="never runs"):
            gpu.encode_chunks(data)
    finally:
        config().clear("ec_kernel")


# ------------------------------------------------- the process cluster --

PC_K, PC_M, PC_SU = 4, 2, 1 << 16


@pytest.fixture(scope="module")
def card_cluster(tmp_path_factory):
    """The port's vstart cluster (6 OSD daemons asked for the CPU) with
    an RS(4,2) bitsliced pool, driven by a RemoteCluster on the card:
    put_many, a staged put_many_from_device and flush_staged, two shard
    holders killed, get_many_to_device and get, out, recover_ec_pool,
    every object read again.  Records, per step, K1's and K3's launches,
    the codec's dispatches and the wire.zero device crc dispatches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (K1 and K3 have no CPU mode)")
    import ceph_tpu_torch
    from ceph_tpu_torch.client.remote import RemoteCluster
    from ceph_tpu_torch.common.perf_counters import perf
    from ceph_tpu_torch.tools.vstart import Vstart, build_cluster_dir
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cuda")
    d = str(tmp_path_factory.mktemp("pc") / "c")
    build_cluster_dir(d, n_osds=6, osds_per_host=1, fsync=False, pools=[
        {"id": 1, "name": "ec", "type": 3, "size": PC_K + PC_M,
         "pg_num": 8, "crush_rule": 1, "erasure_code_profile": "p",
         "stripe_unit": PC_SU}])
    v = Vstart(d)
    v.start(6, hb_interval=0.25)
    rec = {"steps": {}, "reads": {}, "tries": {}}

    def counts():
        ec = perf("ec.jax").dump()
        return (xor_kernel.launches, gf_pallas.fused_launches,
                ec.get("encode_dispatches", 0) +
                ec.get("decode_dispatches", 0),
                perf("wire.zero").dump().get("device_crc_dispatches", 0))

    def step(name, fn, full=None):
        """``fn()`` with its counts.  A write (``full`` given) runs again
        after a map refresh until ``full(result)``: a loaded host can
        make the mon mark a live daemon down for a heartbeat, and a
        write placed then misses that shard (the ack retry of
        tests/test_process_cluster.py).  Reads run once."""
        c0 = counts()
        for tries in range(1, 13):
            out = fn()
            if full is None or full(out):
                break
            time.sleep(0.5)
            rc.refresh_map()
        else:
            raise AssertionError(f"{name}: not every shard acked: {out}")
        torch.cuda.synchronize()
        rec["steps"][name] = [b - a for a, b in zip(c0, counts())]
        rec["tries"][name] = tries
        return out

    try:
        rc = RemoteCluster(d, ec_profiles={"p": {
            "plugin": "jax", "k": str(PC_K), "m": str(PC_M),
            "layout": "bitsliced"}})
        rec["device"] = rc.ec_backend(1).codec.device.type
        rng = np.random.default_rng(71)
        names = [f"o{i}" for i in range(6)]
        datas = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                 for n in (1, 5000, 1 << 16, 300000, 1 << 18, 77777)]
        full = PC_K + PC_M
        rec["acks"] = step("put_many", lambda: rc.put_many(1, names, datas),
                           lambda r: all(a == full for a in r.values()))
        words = torch.as_tensor(rand_words((2 * 3, PC_K, PC_SU // 4), 72),
                                device="cuda")
        step("staged_put", lambda: rc.put_many_from_device(
            1, ["s0", "s1"], words, durable=False),
            lambda r: all(len(t) == full for t in r.values()))
        flushed = []
        step("flush", lambda: flushed.append(rc.flush_staged(1)),
             lambda _r: not any(True for _ in rc.dev.dirty_items()))
        rec["flushed"] = sum(flushed)
        rec["dirty_after_flush"] = len(list(rc.dev.dirty_items()))
        pool = rc.osdmap.pools[1]
        victims = [o for o in rc._up(pool, rc._pg_for(pool, "s0"))
                   if o >= 0][:2]
        for o in victims:
            v.kill9(f"osd.{o}")
        rc.dev.clear()
        outs = step("degraded_get_many_to_device",
                    lambda: rc.get_many_to_device(1, ["s0", "s1"]))
        rec["reads"]["to_device"] = [
            o.device.type == "cuda" and torch.equal(o, words[3 * i:3 * i + 3])
            for i, o in enumerate(outs)]
        gets = step("degraded_get", lambda: [rc.get(1, n) for n in names])
        rec["reads"]["degraded"] = gets == datas
        for o in victims:
            rc.mon_call({"cmd": "mark_out", "osd": o})
        rc.refresh_map()
        rec["recovery"] = step("recover", lambda: rc.recover_ec_pool(1))
        rc.dev.clear()
        gets = step("get_after_recovery",
                    lambda: [rc.get(1, n) for n in names + ["s0", "s1"]])
        rec["reads"]["after_recovery"] = gets == datas + [
            words[:3].cpu().numpy().tobytes(),
            words[3:].cpu().numpy().tobytes()]
        rc.close()
        yield rec
    finally:
        v.stop()
        ceph_tpu_torch.set_default_device(prev)


def test_process_cluster_client_on_card_reads_bit_identical(card_cluster):
    assert card_cluster["device"] == "cuda"
    assert all(a == PC_K + PC_M for a in card_cluster["acks"].values())
    assert card_cluster["flushed"] == 2 * (PC_K + PC_M)
    assert card_cluster["dirty_after_flush"] == 0
    assert all(card_cluster["reads"]["to_device"])
    assert card_cluster["reads"]["degraded"]
    assert card_cluster["reads"]["after_recovery"]
    assert card_cluster["recovery"]["shards_rebuilt"] > 0


def test_process_cluster_k3_launches_equal_the_device_crc_dispatches(
        card_cluster):
    """Every checksum the client computes on the card (the flush's, the
    durable fan-out's, each verified reply frame's) is one K3 crc-leg
    launch, counted as one wire.zero device crc dispatch."""
    total = 0
    for name, (_k1, k3, _ec, crc) in card_cluster["steps"].items():
        assert k3 == crc, name
        total += k3
    assert card_cluster["steps"]["flush"][1] >= 1 and total > 0


def test_process_cluster_k1_launches_per_step(card_cluster):
    """K1 launches once per codec dispatch in every step, as phase 10
    of chip_smoke.py counts them: one encode per put batch, one decode
    per erasure-signature group."""
    steps = card_cluster["steps"]
    for name, (k1, _k3, ec, _crc) in steps.items():
        assert k1 == ec, name
    assert steps["put_many"][0] >= 1
    assert steps["staged_put"][0] == card_cluster["tries"]["staged_put"]
    assert steps["flush"][0] == 0
    assert steps["degraded_get_many_to_device"][0] >= 1


def _powercycle(d):
    from ceph_tpu_torch.cluster.thrasher import (PowerCycleConfig,
                                                 PowerCycleThrasher)
    return PowerCycleThrasher(d, PowerCycleConfig(**PC_CFG)).run()


def test_powercycle_soak_with_the_client_on_the_card(card, tmp_path):
    """tests/test_thrasher.py's powercycle soak, seed 0, with the
    ``RemoteCluster`` on the card (its checksums on K3's crc leg): zero
    acked-write loss, boot fsck clean, and each schedule (card and CPU
    client) equal to the seed's for its kill windows, so the two are
    equal wherever the victims died at the same write (a window's length
    is timing)."""
    import ceph_tpu_torch
    prev = ceph_tpu_torch.default_device()
    try:
        ceph_tpu_torch.set_default_device("cuda")
        got = _powercycle(str(tmp_path / "card"))
        ceph_tpu_torch.set_default_device("cpu")
        want = _powercycle(str(tmp_path / "cpu"))
    finally:
        ceph_tpu_torch.set_default_device(prev)
    assert got["failures"] == [] and got["ok"] is True
    inv = got["invariants"]
    assert inv["acked_writes_lost"] == 0
    assert inv["fsck_errors_post_cycle"] == 0
    assert inv["powercycles"] == 2
    for rep in (got, want):
        assert rep["schedule"] == seeded_schedule(
            kill_windows(rep["schedule"]))
    if kill_windows(got["schedule"]) == kill_windows(want["schedule"]):
        assert got["schedule"] == want["schedule"]


# ---------------------------------------------------------- data plane --

@pytest.mark.parametrize("stripes", [0, 2])
def test_plane_of_four_cells_on_the_card_equals_unsharded_k1(card, stripes):
    """The data plane over 4 cells of one card (1-D and 2 x 2): the put
    encode and the per-stripe rebuild equal one unsharded K1 launch, each
    dispatch launches K1 once per cell, and no plain version runs."""
    from ceph_tpu_torch.entry import plane_cells
    k, m = 8, 3
    masks = torch.as_tensor(gf2.bitmatrix_masks(gf.gf8_bitmatrix(
        gf.vandermonde_parity(k, m))), device=card)
    words = torch.as_tensor(rand_words((13, 8 * k, 512), 90), device=card)
    rmasks = torch.as_tensor(rebuild_masks(13, k, m, 91), device=card)
    rwords = torch.as_tensor(rand_words((13, 8 * (k + m), 512), 92),
                             device=card)
    want_put = xor_kernel.xor_matmul_w32(masks, words)
    want_reb = xor_kernel.xor_matmul_w32(rmasks, rwords)
    with plane_cells(4, stripes, card) as dp:
        plain, n0 = xor_kernel.plain_runs, xor_kernel.launches
        put = dp.xor_matmul_w32(masks, words, kind="put")
        reb = dp.rebuild_collective(rmasks, rwords)
        torch.cuda.synchronize()
        assert xor_kernel.launches - n0 == 2 * 4
        assert xor_kernel.plain_runs == plain
        assert dp.psum_probe() == (16 if not stripes else 14)
    assert put.device.type == reb.device.type == "cuda"
    assert torch.equal(put, want_put) and torch.equal(reb, want_reb)


# ------------------------------------------------------------- gateway --

def _bucket_on_rs83(device):
    """A bucket whose data and index live in an RS(8,3) bitsliced pool
    (12 hosts x 1 OSD, CHOOSELEAF_INDEP host, 4 KiB stripe unit) on
    ``device``: objects put, listed, a multipart object, an OSD lost and
    every object read degraded, out, ``recover_all`` and every object
    read again.  -> (what it read, every object of the pool, K1 launches,
    the ec.jax and rebuild dispatches)."""
    from ceph_tpu_torch.client.rados import Rados
    from ceph_tpu_torch.cluster import simulator
    from ceph_tpu_torch.cluster.monitor import Monitor
    from ceph_tpu_torch.cluster.osdmap import OSDMap, PGPool, POOL_ERASURE
    from ceph_tpu_torch.common.perf_counters import perf
    from ceph_tpu_torch.placement.builder import TYPE_HOST, \
        build_flat_cluster
    from ceph_tpu_torch.placement.crush_map import (
        RULE_CHOOSELEAF_INDEP, RULE_EMIT, RULE_TAKE, Rule)
    from ceph_tpu_torch.rgw.gateway import RGWGateway
    cmap, root = build_flat_cluster(n_hosts=12, osds_per_host=1)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_INDEP, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    om = OSDMap(cmap, device=device)
    om.mark_all_in_up()
    om.add_pool(PGPool(id=1, name="ec", type=POOL_ERASURE, size=11,
                       pg_num=32, crush_rule=0, erasure_code_profile="p",
                       stripe_unit=4096))
    sim = simulator.ClusterSim(om, device=device)
    sim.create_ec_profile("p", {"plugin": "jax", "k": "8", "m": "3",
                                "layout": "bitsliced"})
    mon = Monitor(sim.osdmap)
    gw = RGWGateway(Rados(sim, mon).connect().open_ioctx("ec"))

    def dispatches():
        d = perf("ec.jax").dump()
        return d.get("encode_dispatches", 0) + \
            d.get("decode_dispatches", 0) + simulator.rebuild_dispatches

    n0, d0 = xor_kernel.launches, dispatches()
    rng = np.random.default_rng(41)
    objs = {f"k{i:03d}": rng.integers(0, 256, int(rng.integers(1, 200_000)),
                                      dtype=np.uint8).tobytes()
            for i in range(24)}
    b = gw.create_bucket("b", num_shards=8)
    for k, v in objs.items():
        b.put_object(k, v)
    uid = b.initiate_multipart("mp")
    for n in (1, 2):
        b.upload_part(uid, n, bytes([n]) * 300_000)
    b.complete_multipart(uid, [1, 2])
    out = [b.list_objects(max_keys=100)]
    victim = sim.pg_up(om.pools[1], sim.object_pg(om.pools[1],
                                                  "rgw_data.b/k000"))[0]
    sim.fail_osd(victim)
    for r in range(12):
        if r != victim and mon.report_failure(victim, r):
            break
    out.append([b.get_object(k)[0] == v for k, v in objs.items()])
    inc = mon.next_incremental()
    inc.new_weight[victim] = 0
    mon.commit_incremental(inc)
    out.append(sim.recover_all(1))
    out.append([b.get_object(k)[0] == v for k, v in objs.items()] +
               [b.get_object("mp")[0] == b"\x01" * 300_000 +
                b"\x02" * 300_000])
    if device.type == "cuda":
        torch.cuda.synchronize()
    state = {name: sim.get(pid, name)
             for (pid, name) in sorted(sim.objects)}
    launched, disp = xor_kernel.launches - n0, dispatches() - d0
    sim.shutdown()
    return out, state, launched, disp


def _seeded_tokens_and_clock(monkeypatch):
    """The gateway's tokens (``secrets.token_hex``) and wall clock drawn
    from one seed, so two runs write the same bytes."""
    import random
    import secrets
    import types

    from ceph_tpu_torch.rgw import gateway
    rng, now = random.Random(0), [1_760_000_000.0]

    def token_hex(n=32):
        return rng.getrandbits(8 * n).to_bytes(n, "big").hex()

    def wall():
        now[0] += 0.001
        return now[0]
    monkeypatch.setattr(secrets, "token_hex", token_hex)
    monkeypatch.setattr(gateway, "time", types.SimpleNamespace(
        time=wall, monotonic=time.monotonic, sleep=time.sleep))


def test_bucket_on_rs83_launches_k1_per_dispatch_and_equals_the_cpu(
        card, monkeypatch):
    """The gateway over an RS(8,3) bitsliced pool on the card: K1 launches
    once per codec and rebuild dispatch, no plain version runs, and every
    read, listing, recovery count and object byte equals the same run on
    the CPU (tokens and clock seeded alike in both runs)."""
    import ceph_tpu_torch
    prev = ceph_tpu_torch.default_device()
    try:
        plain = xor_kernel.plain_runs
        with monkeypatch.context() as mp:
            _seeded_tokens_and_clock(mp)
            got = _bucket_on_rs83(card)
        assert xor_kernel.plain_runs == plain
        ceph_tpu_torch.set_default_device("cpu")
        with monkeypatch.context() as mp:
            _seeded_tokens_and_clock(mp)
            want = _bucket_on_rs83(torch.device("cpu"))
    finally:
        ceph_tpu_torch.set_default_device(prev)
    out, state, launched, disp = got
    assert launched == disp and launched > 0
    assert all(out[1]) and all(out[3]) and out[2]["shards_rebuilt"] > 0
    assert want[2] == 0
    assert out == want[0]
    assert state == want[1]


# ------------------------------------------------- the operator's tools --

def _tool(main, argv):
    import contextlib
    import io
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _tool_map(tmp_path):
    """A 12-host x 4-OSD straw2 map with a host-level replicated rule,
    written as a cluster spec of two pools."""
    import json
    from ceph_tpu_torch.placement.builder import TYPE_HOST, \
        build_flat_cluster
    from ceph_tpu_torch.placement.crush_map import (
        RULE_CHOOSELEAF_FIRSTN, RULE_EMIT, RULE_TAKE, Rule)
    cmap, root = build_flat_cluster(n_hosts=12, osds_per_host=4, seed=1,
                                    weight_jitter=True)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    crush = tmp_path / "map.json"
    crush.write_text(json.dumps(cmap.to_spec()))
    spec = tmp_path / "cluster.json"
    spec.write_text(json.dumps({
        "crush": cmap.to_spec(),
        "pools": [{"id": p, "type": 1, "size": 3, "pg_num": 4096,
                   "crush_rule": 0} for p in (1, 2)],
        "osds": {"down": [3], "out": [7]}}))
    return str(crush), str(spec)


def test_crushtool_and_osdmaptool_on_the_card_print_the_cpus_text(
        card, tmp_path):
    from ceph_tpu_torch.tools import crushtool, osdmaptool
    crush, spec = _tool_map(tmp_path)
    runs = [
        (crushtool.main, ["--infn", crush, "--test", "--min-x", "0",
                          "--max-x", "9999", "--num-rep", "3",
                          "--show-utilization", "--show-statistics",
                          "--show-mappings"]),
        (osdmaptool.main, [spec, "--test-map-pgs"]),
        (osdmaptool.main, [spec, "--upmap", str(tmp_path / "up.json")])]
    for main, argv in runs:
        got = _tool(main, argv + ["--device", "cuda"])
        want = _tool(main, argv + ["--device", "cpu"])
        assert got[0] == want[0] == 0
        assert got[1] == want[1] and got[1]


def test_bench_sweep_on_the_card_launches_per_dispatch(card):
    """bench_sweep's rows and skipped cells on the card equal the CPU's;
    K1 and K2 launch, and no plain version runs on the card."""
    from ceph_tpu_torch.tools import bench_sweep
    argv = ["--plugins", "jax,jerasure", "--sizes", "4096,65536",
            "--iters", "2", "--batch", "4"]
    plain = (xor_kernel.plain_runs, gf_pallas.plain_runs)
    k1, k2 = xor_kernel.launches, gf_pallas.launches
    got = _tool(bench_sweep.main, argv + ["--device", "cuda"])
    assert (xor_kernel.plain_runs, gf_pallas.plain_runs) == plain
    assert xor_kernel.launches > k1 and gf_pallas.launches > k2
    want = _tool(bench_sweep.main, argv + ["--device", "cpu"])
    assert got[0] == want[0] == 0

    def rows(text):
        return [ln.rsplit(",", 1)[0] for ln in text.splitlines()]

    def skipped(text):
        return [ln for ln in text.splitlines() if ln.startswith("# ")]

    assert rows(got[1]) == rows(want[1])
    assert skipped(got[2]) == skipped(want[2])
