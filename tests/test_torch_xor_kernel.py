"""The port's K1 (ceph_tpu_torch.ops.xor_kernel) against the reference.

On the CPU the port's wrapper runs the plain PyTorch version of the
masked-XOR contraction; these tests hold it bit-identical to
``ceph_tpu.ops.xor_kernel`` (which takes its XLA ``_combine`` path on
the CPU) and to the NumPy oracle ``gf2.region_xor_matmul_np``, over the
four RS techniques at k4m2 and k8m3.  Mirrors tests/test_gf2.py:42-90.
The kernel itself is held to the plain version on the card in
tests/test_torch_cuda.py.  GF(2) arithmetic: every comparison is exact.
"""
import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.ops import gf as gf_ref
from ceph_tpu.ops import gf2 as gf2_ref
from ceph_tpu.ops import xor_kernel as xk_ref
from ceph_tpu_torch.ops import gf, gf2, xor_kernel

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

PARITY = {"reed_sol_van": "vandermonde_parity",
          "cauchy": "isa_cauchy_parity",
          "cauchy_good": "cauchy_good_parity",
          "isa_rs": "isa_rs_parity"}
CASES = [(t, k, m) for t in PARITY for k, m in ((4, 2), (8, 3))]


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


def parity_bitmatrix(technique, k, m):
    return gf.gf8_bitmatrix(getattr(gf, PARITY[technique])(k, m))


def decode_bitmatrix(technique, k, m, erased):
    """Bit-matrix rebuilding ``erased`` from the first k survivors."""
    G = gf.generator_matrix(getattr(gf, PARITY[technique])(k, m))
    avail = [c for c in range(k + m) if c not in erased][:k]
    R = gf.gf_matmul(G[sorted(erased)], gf.gf_gaussian_inverse(G[avail]))
    return gf.gf8_bitmatrix(R)


def port_u8(masks, planes):
    return xor_kernel.xor_matmul(masks, planes).numpy()


def ref_u8(masks, planes):
    return np.asarray(xk_ref.xor_matmul(masks, planes), dtype=np.uint8)


@pytest.mark.parametrize("technique,k,m", CASES)
def test_matrices_equal_reference(technique, k, m):
    """The copied GF tables build the reference's bit-matrices."""
    P = getattr(gf, PARITY[technique])(k, m)
    assert np.array_equal(P, getattr(gf_ref, PARITY[technique])(k, m))
    B = gf.gf8_bitmatrix(P)
    assert np.array_equal(B, gf_ref.gf8_bitmatrix(P))
    assert np.array_equal(gf2.bitmatrix_masks(B),
                          gf2_ref.bitmatrix_masks(B))


@pytest.mark.parametrize("technique,k,m", CASES)
def test_shared_masks_match_reference(technique, k, m):
    rng = np.random.default_rng(1)
    B = parity_bitmatrix(technique, k, m)
    masks = gf2.bitmatrix_masks(B)
    pl = rng.integers(0, 256, size=(3, 8 * k, 128), dtype=np.uint8)
    got = port_u8(masks, pl)
    assert got.dtype == np.uint8 and got.shape == (3, 8 * m, 128)
    assert np.array_equal(got, ref_u8(masks, pl))
    assert np.array_equal(got, gf2_ref.region_xor_matmul_np(B, pl))


@pytest.mark.parametrize("technique,k,m", CASES)
def test_per_batch_masks_match_reference(technique, k, m):
    """Each batch element combines under its own bit-matrix — the
    per-stripe-signature rebuild shape."""
    rng = np.random.default_rng(2)
    mats = [parity_bitmatrix(technique, k, m),
            decode_bitmatrix(technique, k, m, list(range(m))),
            decode_bitmatrix(technique, k, m, list(range(k, k + m)))]
    masks = np.stack([gf2.bitmatrix_masks(b) for b in mats])
    words = rng.integers(-2**31, 2**31, size=(3, 8 * k, 32),
                         dtype=np.int64).astype(np.int32)
    got = xor_kernel.xor_matmul_w32(masks, words).numpy()
    ref = np.asarray(xk_ref.xor_matmul_w32(masks, words), dtype=np.int32)
    assert got.dtype == np.int32
    assert np.array_equal(got, ref)
    for i, b in enumerate(mats):
        oracle = gf2_ref.region_xor_matmul_np(b, words[i].view(np.uint8)
                                              .reshape(8 * k, 128))
        assert np.array_equal(got[i].view(np.uint8).reshape(-1, 128),
                              oracle)


@pytest.mark.parametrize("technique,k,m", CASES)
def test_unaligned_tail(technique, k, m):
    """A word count (W=13) and a byte count (P=52) that fill no tile."""
    rng = np.random.default_rng(3)
    masks = gf2.bitmatrix_masks(parity_bitmatrix(technique, k, m))
    words = rng.integers(-2**31, 2**31, size=(2, 8 * k, 13),
                         dtype=np.int64).astype(np.int32)
    got = xor_kernel.xor_matmul_w32(masks, words).numpy()
    assert np.array_equal(
        got, np.asarray(xk_ref.xor_matmul_w32(masks, words), np.int32))
    pl = rng.integers(0, 256, size=(3, 8 * k, 52), dtype=np.uint8)
    assert np.array_equal(port_u8(masks, pl), ref_u8(masks, pl))


@pytest.mark.parametrize("technique,k,m", CASES)
def test_w32_domain_matches_u8(technique, k, m):
    rng = np.random.default_rng(4)
    masks = gf2.bitmatrix_masks(parity_bitmatrix(technique, k, m))
    pl = rng.integers(0, 256, size=(2, 8 * k, 256), dtype=np.uint8)
    via_u8 = port_u8(masks, pl)
    w = xor_kernel._u8_to_i32(torch.from_numpy(pl))
    via_w32 = xor_kernel._i32_to_u8(
        xor_kernel.xor_matmul_w32(masks, w)).numpy()
    assert np.array_equal(via_u8, via_w32)


def test_mask_batch_mismatch_raises():
    masks = np.zeros((2, 16, 32), dtype=np.int32)
    pl = np.zeros((3, 32, 64), dtype=np.uint8)
    with pytest.raises(ValueError, match="mask batch"):
        xor_kernel.xor_matmul(masks, pl)
    with pytest.raises(ValueError):
        xk_ref.xor_matmul(masks, pl)


def test_column_mismatch_raises():
    masks = np.zeros((16, 24), dtype=np.int32)
    words = np.zeros((3, 32, 16), dtype=np.int32)
    with pytest.raises(ValueError, match="columns"):
        xor_kernel.xor_matmul_w32(masks, words)
    with pytest.raises(ValueError):
        xk_ref.xor_matmul_w32(masks, words)


def test_wrong_dtype_raises():
    with pytest.raises(TypeError):
        xor_kernel.xor_matmul_w32(np.zeros((8, 8), np.int32),
                                  torch.zeros((8, 4), dtype=torch.int64))


def test_masks_to_device_caches_by_content():
    B = parity_bitmatrix("reed_sol_van", 4, 2)
    a = xor_kernel.masks_to_device(B)
    assert a is xor_kernel.masks_to_device(B.copy())
    assert a.dtype == torch.int32 and a.device.type == "cpu"
    assert np.array_equal(a.numpy(), gf2_ref.bitmatrix_masks(B))
    other = parity_bitmatrix("cauchy", 4, 2)
    assert xor_kernel.masks_to_device(other) is not a
    assert np.array_equal(np.asarray(xk_ref.masks_to_device(B)), a.numpy())


def test_first_upload_of_a_mask_operand_is_a_compile_span():
    """The first upload of an operand to a device (the counterpart of the
    reference's first compile for a new shape) is one ``jit.compile``
    child span of the op, component ``ec.xor_kernel``; a cached operand
    makes none, and the ``jit`` perf group is not written."""
    from ceph_tpu_torch.common.perf_counters import perf
    from ceph_tpu_torch.common.tracer import tracer
    B = np.random.default_rng(7).integers(0, 2, (24, 40), dtype=np.uint8)
    jit0 = perf("jit").dump()
    tracer().reset()
    with tracer().start_span("op"):
        xor_kernel.masks_to_device(B)
        xor_kernel.masks_to_device(B.copy())
    spans = [s for s in tracer().dump_traces()["spans"]
             if s["name"] == "jit.compile"]
    assert [(s["tags"]["component"], s["tags"]["signature"])
            for s in spans] == [("ec.xor_kernel", "24x40")]
    assert perf("jit").dump() == jit0


def test_cpu_tensor_runs_plain_version_and_no_launch():
    B = parity_bitmatrix("reed_sol_van", 8, 3)
    words = torch.zeros((2, 64, 16), dtype=torch.int32)
    runs, launches = xor_kernel.plain_runs, xor_kernel.launches
    xor_kernel.xor_matmul_w32(xor_kernel.masks_to_device(B), words)
    assert xor_kernel.plain_runs == runs + 1
    assert xor_kernel.launches == launches


# ------------------------------------------------------------ launch plan --
#
# On the card the wrapper launches K1 under a plan it chooses in Python
# (``xor_kernel.plan``).  These tests hold the plan to the kernel's
# contract at every shape chip_smoke.py holds K1 at, and emulate the
# kernel's walk over the plan's work items (items grid-stride, stages,
# warps splitting the contraction, the fold) on the CPU: every output
# word must be written exactly once, and equal to the plain version.

H100_SMS = 132
H100_SMEM_LIMIT = 232_448       # a block's opt-in limit on an H100

# (B, R, C, W, per_batch) of every K1 shape chip_smoke.py's phase 2 holds
# (its kernel_check lines on the card): the main path, phases 10, 11 and
# 13, the plugins' w = 8/7/6, rados (10b) and bench_sweep (8b)
HELD = [
    (1, 8, 64, 128, False), (1, 16, 32, 8192, False),
    (1, 16, 32, 32768, False), (1, 16, 64, 128, False),
    (1, 24, 64, 128, False), (1, 24, 88, 128, True), (2, 24, 64, 128, False),
    (2, 24, 88, 128, True), (3, 24, 64, 128, False), (5, 8, 64, 128, False),
    (5, 16, 64, 128, False), (5, 24, 64, 128, False),
    (6, 12, 36, 5462, False), (6, 14, 35, 4682, False),
    (6, 16, 48, 4096, False), (7, 24, 88, 128, True),
    (8, 16, 64, 32768, False), (8, 24, 64, 32768, False),
    (16, 12, 24, 43, False), (16, 12, 24, 10923, False),
    (16, 14, 28, 37, False), (16, 14, 28, 9363, False),
    (16, 16, 32, 32, False), (16, 16, 32, 8192, False),
    (16, 16, 64, 16, False), (16, 16, 64, 4096, False),
    (16, 24, 32, 32, False), (16, 24, 32, 8192, False),
    (16, 24, 64, 16, False), (16, 24, 64, 4095, False),
    (16, 24, 64, 4096, False), (16, 24, 64, 32768, False),
    (17, 24, 64, 128, False), (29, 24, 64, 128, False),
    (32, 8, 64, 128, False), (32, 16, 64, 128, False),
    (32, 24, 64, 128, False), (32, 24, 64, 4096, False),
    (32, 24, 88, 128, True), (128, 8, 64, 128, False),
    (128, 16, 64, 128, False), (128, 24, 64, 128, False),
    (171, 24, 64, 128, False), (256, 8, 64, 128, False),
    (256, 16, 64, 128, False), (256, 24, 64, 128, False),
    (256, 24, 88, 128, True), (512, 24, 64, 4096, False),
    (512, 24, 64, 32768, False), (512, 24, 88, 4096, True),
]


def emulate(p, m3, w3, per_batch):
    """K1's walk over plan ``p`` in NumPy: returns (out, writes), the
    output and how often each output word was stored."""
    B, C, W = w3.shape
    R = m3.shape[1]
    tw = p.tile_words
    nchunks = max(1, -(-C // p.cc))
    out = np.full((B, R, W), 0x5A5A5A5A, dtype=np.int32)
    writes = np.zeros((B, R, W), dtype=np.int32)
    for it in range(p.grid):                    # one block an item
        if True:
            bt, g = divmod(it, p.groups)
            b, tile = divmod(bt, p.tiles)
            w0, g0 = tile * tw, g * p.rg
            rows, cols = min(p.rg, R - g0), min(tw, W - w0)
            mb = m3[b if per_batch else 0]
            part = np.zeros((p.ks, p.rg, tw), dtype=np.int32)
            for k in range(nchunks):
                c0 = k * p.cc
                for ks in range(p.ks):
                    for c in range(ks, min(p.cc, C - c0), p.ks):
                        d = np.zeros(tw, dtype=np.int32)
                        d[:cols] = w3[b, c0 + c, w0:w0 + cols]
                        part[ks, :rows] ^= (mb[g0:g0 + rows, c0 + c, None]
                                            & d[None, :])
            acc = np.bitwise_xor.reduce(part, axis=0)
            out[b, g0:g0 + rows, w0:w0 + cols] = acc[:rows, :cols]
            writes[b, g0:g0 + rows, w0:w0 + cols] += 1
    return out, writes


@pytest.mark.parametrize("B,R,C,W,per_batch", HELD)
def test_plan_at_every_held_shape(B, R, C, W, per_batch):
    p = xor_kernel.plan(B, R, C, W, per_batch, True, H100_SMS)
    assert p.vec == (4 if W % 4 == 0 else 1)
    assert p.ctw * p.ks == 4 and p.ctw in (1, 2, 4)
    assert p.tile_words * (p.tiles - 1) < W <= p.tile_words * p.tiles
    assert p.rg in (8, 16, 24, 32)
    assert p.rg * (p.groups - 1) < R <= p.rg * p.groups
    assert p.grid == B * p.tiles * p.groups      # one block an item
    assert 1 <= p.cc <= max(C, 1) and 1 <= p.stages <= 4
    assert p.smem == xor_kernel.smem_needed(R, C, p.vec, p.rg, p.ctw, p.cc,
                                            p.stages)
    assert p.smem <= H100_SMEM_LIMIT
    if W == 128:
        # 4 KiB stripe units: the whole slab one stage, every warp at work
        # on the same 128 words, a small batch cut into row groups of 8
        assert (p.cc, p.ks, p.tiles) == (C, 4, 1)
        if B * -(-R // xor_kernel.row_group(R)) < H100_SMS // 2:
            assert p.rg == 8
    if W >= 4096 and p.vec == 4:
        # wide: tiles four warps wide, a ring of two stages, half size per
        # stripe or where the larger ring would keep an SM from its blocks
        assert (p.ks, p.stages) == (1, xor_kernel.RING)
        stage = 4 * p.cc * p.tile_words
        assert stage in (xor_kernel.WIDE_STAGE, xor_kernel.WIDE_STAGE // 2)
        if per_batch:
            assert stage == xor_kernel.WIDE_STAGE // 2
    else:
        assert p.stages == 1                # the whole slab at once


@pytest.mark.parametrize("B,R,C,W,per_batch", [
    (1, 24, 64, 128, False), (5, 24, 64, 128, False),
    (3, 24, 88, 128, True), (2, 16, 64, 512, False), (2, 24, 64, 256, True),
    (2, 16, 35, 37, False), (2, 16, 36, 43, False), (2, 24, 16, 1, False),
    (3, 24, 64, 13, True), (2, 72, 16, 130, False), (2, 40, 20, 999, True),
    (1, 33, 8, 1000, False), (2, 24, 64, 4095, False),
    (1, 8, 200, 600, False), (1, 3, 0, 8, False),
])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_walk_writes_every_word_once(B, R, C, W, per_batch, aligned):
    """The kernel's walk, emulated at small shapes (the row groups, the
    split contraction, ragged tiles and chunks): every output word is
    stored once and equals the plain version."""
    rng = np.random.default_rng(B * 1000 + R * 10 + C + W)
    words = rng.integers(-2**31, 2**31, size=(B, C, W),
                         dtype=np.int64).astype(np.int32)
    masks = -rng.integers(0, 2, size=(B if per_batch else 1, R, C),
                          dtype=np.int64).astype(np.int32)
    for sms in (H100_SMS, 2):
        p = xor_kernel.plan(B, R, C, W, per_batch, aligned, sms)
        assert p.grid == B * p.tiles * p.groups
        got, writes = emulate(p, masks, words, per_batch)
        assert (writes == 1).all()
        want = xor_kernel._combine_torch(torch.from_numpy(masks),
                                         torch.from_numpy(words)) \
            if C else torch.zeros((B, R, W), dtype=torch.int32)
        assert np.array_equal(got, want.numpy())


def test_plan_refuses_past_the_shared_memory_limit():
    """A block stages its row group's masks whole: at R = 32 there is a
    largest C that fits the H100's opt-in limit, and one more does not;
    every matrix the first port took (Rp x C x 4 <= 48 KiB: C <= 384 at
    R = 32) fits, at a batch of 1 and of 512, shared or per stripe."""
    def smem(C, B=1, per_batch=False):
        return xor_kernel.plan(B, 32, C, 8, per_batch, True, H100_SMS).smem
    C = 384
    while smem(C + 1) <= H100_SMEM_LIMIT:
        C += 1
    assert smem(C) <= H100_SMEM_LIMIT < smem(C + 1)
    for B in (1, 512):
        for per_batch in (False, True):
            assert smem(384, B, per_batch) <= H100_SMEM_LIMIT


def test_row_group_is_the_smallest_that_covers():
    assert [xor_kernel.row_group(R) for R in
            (1, 8, 9, 17, 24, 25, 32, 33, 72)] == \
        [8, 8, 16, 24, 24, 32, 32, 32, 32]


def test_cpu_tensor_never_takes_a_cuda_path(monkeypatch):
    """CPU operands go to the plain version: no plan, no library, no
    launch; the launch floor refuses them."""
    def refuse(*_a, **_k):
        raise AssertionError("a CUDA path was taken for a CPU tensor")
    for name in ("_lib", "_card", "_card_plan", "launch_plan", "_launch"):
        monkeypatch.setattr(xor_kernel, name, refuse)
    masks = torch.from_numpy(gf2.bitmatrix_masks(
        parity_bitmatrix("reed_sol_van", 8, 3)))
    words = torch.zeros((3, 64, 128), dtype=torch.int32)
    runs, launches = xor_kernel.plain_runs, xor_kernel.launches
    out = xor_kernel.xor_matmul_w32(masks, words)
    assert out.device.type == "cpu" and out.shape == (3, 24, 128)
    assert xor_kernel.plain_runs == runs + 1
    assert xor_kernel.launches == launches
    with pytest.raises(ValueError, match="on the card"):
        xor_kernel.matmul_floor(masks, words)
