"""K1 on the card: the CUDA kernel against its plain PyTorch version.

Every test here needs an NVIDIA card and skips without one (the decision
is made inside a fixture, never at import).  Run on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py

The file imports no JAX: its NumPy oracle is ceph_tpu/ops/gf2.py, which
is NumPy-only.  GF(2) arithmetic: every comparison is exact.
"""
import numpy as np
import pytest
import torch

from ceph_tpu.ops import gf2 as gf2_ref
from ceph_tpu_torch.ec import instance
from ceph_tpu_torch.ops import gf, gf2, xor_kernel

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
