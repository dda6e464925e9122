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
reached through the K2 wrapper for a CPU tensor) AND a NumPy walk of
the kernel's table path (``kernel_tables_emulation``: the nibble tables
in the kernel's shared-memory layout, 64-bit pairs of row groups, row
batches, byte-permute addressing and the output transpose), so the
tables and the layout the card reads are held to the reference here,
at m up to 20, k up to 32 and the column edges around 16 and 4096.
The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ops import gf as ref_gf
from ceph_tpu.ops import gf_jax as ref_gf_jax
from ceph_tpu_torch.ops import gf, gf_jax, gf_pallas

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

PARITY = {"reed_sol_van": gf.vandermonde_parity,
          "cauchy": gf.isa_cauchy_parity,
          "cauchy_good": gf.cauchy_good_parity,
          "isa_rs": gf.isa_rs_parity}


def reference(bitmat, data):
    return np.asarray(ref_gf_jax.bitplane_matmul(
        jnp.asarray(bitmat.astype(np.int8)), jnp.asarray(data)))


def byte_perm(x, y, sel: int):
    """CUDA's __byte_perm on uint32 arrays: result byte i is byte
    (sel >> 4i) & 7 of the eight bytes y:x."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(np.broadcast(x, y).shape, dtype=np.uint64)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * src)) & np.uint64(0xFF)) \
            << np.uint64(8 * i)
    return out.astype(np.uint32)


def kernel_tables_emulation(bitmat, data):
    """What K2 computes, walked in NumPy the way csrc/gf_bitplane.cu
    walks it: the nibble tables ``gf_pallas.nibble_tables`` copied into
    a shared-memory image per pass of up to four row groups (each data
    row 256 B per pair of groups; a pair's entries 64-bit, group 2q in
    the low word; a single last group's entries 32-bit, 8 B apart; lo
    nibble at +8n, hi at +128 + 8n), the data read as little-endian
    words in batches of 8 rows (4 from three groups up), each lookup's
    address the byte permute of the pre-shifted nibble into the row's
    256-aligned base, and the accumulators transposed to output rows by
    byte permutes.  Columns past L read as zero and are not stored."""
    nib = gf_pallas.nibble_tables(bitmat)            # [NG, k, 32] uint32
    NG, k, _ = nib.shape
    m = bitmat.shape[0] // 8
    L = data.shape[-1]
    lead = data.shape[:-2]
    Lw = -(-L // 4) * 4
    padded = np.zeros(lead + (k, Lw), dtype=np.uint8)
    padded[..., :L] = data
    words = padded.view("<u4")                       # [..., k, Lw / 4]
    out = np.zeros(lead + (m, L), dtype=np.uint8)
    for g0 in range(0, NG, 4):
        G = min(4, NG - g0)
        P = G // 2
        row_bytes = 256 * ((G + 1) // 2)
        smem = np.zeros(k * row_bytes, dtype=np.uint8)
        tab = nib[g0:g0 + G].reshape(-1)
        for i, v in enumerate(tab):                  # the block's copy
            e, (g, j) = i & 31, divmod(i // 32, k)
            off = (j * row_bytes + (g >> 1) * 256 + ((e & 16) << 3) +
                   8 * (e & 15) + 4 * (g & 1))
            smem[off:off + 4] = np.frombuffer(
                np.uint32(v).tobytes(), dtype=np.uint8)
        s32 = smem.view("<u4")
        s64 = smem.view("<u8")
        acc = np.zeros((G,) + lead + (Lw,), dtype=np.uint32)
        batch = 8 if G <= 2 else 4
        for j0 in range(0, k, batch):
            for j in range(j0, min(j0 + batch, k)):
                rb = np.uint32(j * row_bytes)        # 256-aligned
                w = words[..., j, :]
                lo = (w << np.uint32(3)) & np.uint32(0x78787878)
                hi = (w >> np.uint32(1)) & np.uint32(0x78787878)
                for s in range(4):
                    alo = byte_perm(lo, rb, 0x7650 | s).astype(np.int64)
                    ahi = byte_perm(hi, rb, 0x7650 | s).astype(np.int64)
                    for q in range(P):
                        pair = (s64[(alo + 256 * q) // 8] ^
                                s64[(ahi + 256 * q + 128) // 8])
                        acc[2 * q][..., s::4] ^= \
                            (pair & 0xFFFFFFFF).astype(np.uint32)
                        acc[2 * q + 1][..., s::4] ^= \
                            (pair >> np.uint64(32)).astype(np.uint32)
                    if G % 2:
                        acc[G - 1][..., s::4] ^= (
                            s32[(alo + 256 * P) // 4] ^
                            s32[(ahi + 256 * P + 128) // 4])
        for g in range(G):
            a = acc[g].reshape(lead + (Lw // 4, 4))
            for r in range(4 * g, min(4 * g + 4, m - 4 * g0)):
                sel = (r - 4 * g) | ((r - 4 * g + 4) << 4)
                w0 = byte_perm(a[..., 0], a[..., 1], sel)
                w1 = byte_perm(a[..., 2], a[..., 3], sel)
                row = byte_perm(w0, w1, 0x5410)
                out[..., 4 * g0 + r, :] = np.ascontiguousarray(row) \
                    .view(np.uint8)[..., :L]
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


@pytest.mark.parametrize("k", [1, 8, 20, 32])
@pytest.mark.parametrize("m", [1, 3, 4, 5, 8, 17, 20])
def test_kernel_walk_equals_reference_at_row_and_column_edges(m, k):
    """The kernel's walk with one to five row groups (single, paired,
    paired + single; two passes from m = 17), one to four row batches,
    and L at the edges of a 16-byte thread and a 4 KiB span, against
    the reference on random bit-matrices (one product at the widest L;
    columns are independent, so each L is its prefix)."""
    rng = np.random.default_rng(100 * m + k)
    bitmat = rng.integers(0, 2, size=(8 * m, 8 * k), dtype=np.uint8)
    data = rng.integers(0, 256, size=(2, k, 4097), dtype=np.uint8)
    want = reference(bitmat, data)
    assert np.array_equal(port_plain(bitmat, data), want)
    for L in (1, 15, 16, 17, 4095, 4097):
        got = kernel_tables_emulation(bitmat,
                                      np.ascontiguousarray(data[..., :L]))
        assert np.array_equal(got, want[..., :L]), L


def test_timing_variants_still_apply_to_the_kernel_source():
    """k2_variants.py times text-edited copies of csrc/gf_bitplane.cu:
    every edit must still find its text, and only ``kernel`` is the
    source unchanged."""
    import pathlib
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import k2_variants
    src = (root / "ceph_tpu_torch" / "csrc" / "gf_bitplane.cu").read_text()
    out = k2_variants.variants(src)
    assert out.pop("kernel") == src
    assert len(out) == 7 and all(text != src for text in out.values())


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
