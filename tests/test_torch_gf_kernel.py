"""K2's plain version and its host table builder against ceph_tpu.

The Pallas kernel (ceph_tpu/ops/gf_pallas.py) does not run on the CPU;
its XLA twin ``ceph_tpu.ops.gf_jax.bitplane_matmul`` is the reference
the JAX package's own tests use, and ``ceph_tpu.ops.gf.gf_matmul`` is the
table oracle.  Three checks, all exact (GF(2^8) has no tolerance):

  * GF-derived bit-matrices (the four RS techniques' parity and a decode
    matrix) against gf_jax.bitplane_matmul and gf.gf_matmul;
  * RANDOM bit-matrices (not from any GF(2^8) matrix) against
    gf_jax.bitplane_matmul — the table formulation holds for any bitmat;
  * ragged L (13, 2049).

Each check runs the port's plain version (``gf_jax.bitplane_matmul``,
reached through the K2 wrapper for a CPU tensor) AND a NumPy emulation
of the kernel's table path (``tables_host`` + ``pack_tables``, one
lookup per input byte serving up to four output rows), so the tables
the card reads are held to the reference here.  The kernel itself is
held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ops import gf as ref_gf
from ceph_tpu.ops import gf_jax as ref_gf_jax
from ceph_tpu_torch.ops import gf, gf_jax, gf_pallas

PARITY = {"reed_sol_van": gf.vandermonde_parity,
          "cauchy": gf.isa_cauchy_parity,
          "cauchy_good": gf.cauchy_good_parity,
          "isa_rs": gf.isa_rs_parity}


def reference(bitmat, data):
    return np.asarray(ref_gf_jax.bitplane_matmul(
        jnp.asarray(bitmat.astype(np.int8)), jnp.asarray(data)))


def kernel_tables_emulation(bitmat, data):
    """What K2 computes, in NumPy: out_i = XOR_j byte_(i%4) of
    tab[i//4, j, data_j] over the packed host tables."""
    packed = gf_pallas.pack_tables(gf_pallas.tables_host(bitmat))
    m = bitmat.shape[0] // 8
    k = data.shape[-2]
    out = np.zeros(data.shape[:-2] + (m, data.shape[-1]), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            word = packed[i // 4, j][data[..., j, :]]
            out[..., i, :] ^= ((word >> (8 * (i % 4))) & 0xFF) \
                .astype(np.uint8)
    return out


def port_plain(bitmat, data):
    runs = gf_pallas.plain_runs
    out = gf_pallas.bitplane_matmul(bitmat, torch.from_numpy(data))
    assert gf_pallas.plain_runs == runs + 1     # CPU tensor: plain version
    return out.numpy()


@pytest.mark.parametrize("technique", sorted(PARITY))
@pytest.mark.parametrize("k,m", [(4, 2), (8, 3)])
def test_gf_matrices_equal_reference(technique, k, m):
    rng = np.random.default_rng(k * 10 + m)
    parity = PARITY[technique](k, m)
    assert np.array_equal(parity, getattr(
        ref_gf, PARITY[technique].__name__)(k, m))
    bitmat = gf.gf8_bitmatrix(parity)
    data = rng.integers(0, 256, size=(3, k, 96), dtype=np.uint8)
    want = reference(bitmat, data)
    oracle = np.stack([ref_gf.gf_matmul(parity, d) for d in data])
    assert np.array_equal(want, oracle)
    assert np.array_equal(port_plain(bitmat, data), want)
    assert np.array_equal(kernel_tables_emulation(bitmat, data), want)


def test_decode_matrix_equals_reference():
    k, m = 8, 3
    G = gf.generator_matrix(gf.vandermonde_parity(k, m))
    erased = [1, 4, 9]
    avail = [c for c in range(k + m) if c not in erased][:k]
    R = gf.gf_matmul(G[erased], gf.gf_gaussian_inverse(G[avail]))
    data = np.random.default_rng(3).integers(0, 256, size=(2, k, 64),
                                             dtype=np.uint8)
    bitmat = gf.gf8_bitmatrix(R)
    want = reference(bitmat, data)
    assert np.array_equal(port_plain(bitmat, data), want)
    assert np.array_equal(gf_jax.gf8_matmul(R, torch.from_numpy(data))
                          .numpy(), want)
    assert np.array_equal(kernel_tables_emulation(bitmat, data), want)


@pytest.mark.parametrize("m,k,L,seed", [
    (3, 8, 13, 0), (2, 4, 2049, 1), (5, 7, 64, 2), (9, 3, 40, 3),
    (20, 2, 16, 4),
])
def test_random_bitmatrices_and_ragged_lengths(m, k, L, seed):
    rng = np.random.default_rng(seed)
    bitmat = rng.integers(0, 2, size=(8 * m, 8 * k), dtype=np.uint8)
    data = rng.integers(0, 256, size=(2, k, L), dtype=np.uint8)
    want = reference(bitmat, data)
    assert np.array_equal(port_plain(bitmat, data), want)
    assert np.array_equal(kernel_tables_emulation(bitmat, data), want)


def test_tables_are_the_byte_maps_of_the_bit_blocks():
    """T[i, j, v] = pack(B_ij . bits(v)), checked against the reference
    unpack/matmul/pack on every byte value."""
    rng = np.random.default_rng(5)
    m, k = 3, 4
    bitmat = rng.integers(0, 2, size=(8 * m, 8 * k), dtype=np.uint8)
    T = gf_pallas.tables_host(bitmat)
    assert T.shape == (m, k, 256) and T.dtype == np.uint8
    v = np.arange(256, dtype=np.uint8)
    for j in range(k):
        data = np.zeros((k, 256), dtype=np.uint8)
        data[j] = v
        assert np.array_equal(reference(bitmat, data[None])[0], T[:, j])
    packed = gf_pallas.pack_tables(T)
    assert packed.shape == (1, k, 256) and packed.dtype == np.uint32
    for i in range(m):
        assert np.array_equal((packed[0] >> (8 * i)) & 0xFF, T[i])
    assert not (packed[0] >> 24).any()


def test_unpack_pack_round_trip_and_leading_axes():
    data = np.random.default_rng(6).integers(0, 256, size=(2, 3, 5, 17),
                                             dtype=np.uint8)
    t = torch.from_numpy(data)
    bits = gf_jax.unpack_bits(t)
    assert bits.shape == (2, 3, 40, 17)
    assert np.array_equal(bits.numpy(), np.asarray(
        ref_gf_jax.unpack_bits(jnp.asarray(data))).astype(np.uint8))
    assert torch.equal(gf_jax.pack_bits(bits), t)
    bitmat = gf.gf8_bitmatrix(gf.vandermonde_parity(5, 2))
    out = gf_pallas.bitplane_matmul(bitmat, t)
    assert out.shape == (2, 3, 2, 17)
    assert np.array_equal(out.numpy(), reference(bitmat, data))


def test_matrix_to_device_cache_is_keyed_by_content():
    A = gf.vandermonde_parity(4, 2)
    a = gf_jax.matrix_to_device(A, "cpu")
    assert gf_jax.matrix_to_device(A.copy(), "cpu") is a
    assert torch.equal(a, torch.from_numpy(gf.gf8_bitmatrix(A)))
    B = gf.vandermonde_parity(4, 3)
    assert gf_jax.matrix_to_device(B, "cpu").shape == (24, 32)


def test_wrapper_rejects_wrong_inputs():
    bitmat = gf.gf8_bitmatrix(gf.vandermonde_parity(4, 2))
    with pytest.raises(TypeError):
        gf_pallas.bitplane_matmul(bitmat, torch.zeros((1, 4, 8),
                                                      dtype=torch.int32))
    with pytest.raises(ValueError, match="contract"):
        gf_pallas.bitplane_matmul(bitmat, torch.zeros((1, 5, 8),
                                                      dtype=torch.uint8))
    with pytest.raises(TypeError):
        gf_pallas.bitplane_matmul(bitmat, np.zeros((1, 4, 8), np.uint8))
