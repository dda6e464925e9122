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


def test_cpu_tensor_runs_plain_version_and_no_launch():
    B = parity_bitmatrix("reed_sol_van", 8, 3)
    words = torch.zeros((2, 64, 16), dtype=torch.int32)
    runs, launches = xor_kernel.plain_runs, xor_kernel.launches
    xor_kernel.xor_matmul_w32(xor_kernel.masks_to_device(B), words)
    assert xor_kernel.plain_runs == runs + 1
    assert xor_kernel.launches == launches
