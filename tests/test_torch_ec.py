"""The port's 'jax' codec (layout=bitsliced and layout=bytes) against
ceph_tpu's.

One profile dict builds both codecs; the same NumPy inputs (from
``np.random.default_rng``) go through both, on the CPU, and every
result must be bit-identical — GF(2) arithmetic has no tolerance.
Covers the four RS techniques at k4m2 and k8m3: parity and decode
matrices, encode in both domains, decode in both domains for EVERY
erasure set of size <= m, minimum_to_decode, the host encode/decode API,
and the pinned corpus bytes of tests/golden/ec_corpus.npz.
"""
import functools
import itertools
import os
import sys

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.ec import instance as ref_instance
from ceph_tpu_torch.ec import instance
from ceph_tpu_torch.ec.interface import ErasureCodeError

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "scripts"))
from gen_ec_corpus import payload, profile_for  # noqa: E402

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

TECHNIQUES = ("reed_sol_van", "cauchy", "cauchy_good", "isa_rs")
CASES = [(t, k, m) for t in TECHNIQUES for k, m in ((4, 2), (8, 3))]
CHUNK = 64            # bytes per chunk: W = 16 words, 2 per plane
CORPUS = os.path.join(os.path.dirname(__file__), "golden",
                      "ec_corpus.npz")


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


def profile(technique, k, m):
    return {"k": str(k), "m": str(m), "layout": "bitsliced",
            "technique": technique}


@functools.lru_cache(maxsize=None)
def codecs(technique, k, m):
    prof = profile(technique, k, m)
    return (instance().factory("jax", dict(prof), device="cpu"),
            ref_instance().factory("jax", dict(prof)))


def erasure_sets(n, m):
    for r in range(1, m + 1):
        yield from (list(e) for e in itertools.combinations(range(n), r))


def random_words(rng, shape):
    return rng.integers(-2**31, 2**31, size=shape,
                        dtype=np.int64).astype(np.int32)


def ref_np(x, dtype):
    return np.asarray(x, dtype=dtype)


@pytest.mark.parametrize("technique,k,m", CASES)
def test_parity_and_decode_matrix_equal_reference(technique, k, m):
    port, ref = codecs(technique, k, m)
    assert np.array_equal(port.parity, ref.parity)
    assert port.get_profile() == ref.get_profile()
    for erased in erasure_sets(k + m, m):
        avail = [c for c in range(k + m) if c not in erased]
        R, used = port.decode_matrix(avail, erased)
        R_ref, used_ref = ref.decode_matrix(avail, erased)
        assert np.array_equal(R, R_ref) and used == used_ref, erased


@pytest.mark.parametrize("technique,k,m", CASES)
def test_encode_chunks(technique, k, m):
    port, ref = codecs(technique, k, m)
    rng = np.random.default_rng(10)
    data = rng.integers(0, 256, size=(k, CHUNK), dtype=np.uint8)
    got = port.encode_chunks(data)
    assert got.dtype == np.uint8 and got.shape == (m, CHUNK)
    assert np.array_equal(got, ref_np(ref.encode_chunks(data), np.uint8))
    batch = rng.integers(0, 256, size=(3, k, 2 * CHUNK), dtype=np.uint8)
    assert np.array_equal(port.encode_chunks_batch(batch),
                          ref_np(ref.encode_chunks_batch(batch), np.uint8))


@pytest.mark.parametrize("technique,k,m", CASES)
def test_encode_words_device(technique, k, m):
    port, ref = codecs(technique, k, m)
    words = random_words(np.random.default_rng(11), (4, k, CHUNK // 4))
    got = port.encode_words_device(torch.from_numpy(words))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          ref_np(ref.encode_words_device(words), np.int32))


@pytest.mark.parametrize("technique,k,m", CASES)
def test_decode_words_device_every_erasure_set(technique, k, m):
    port, ref = codecs(technique, k, m)
    n = k + m
    data = random_words(np.random.default_rng(12), (2, k, CHUNK // 4))
    par = port.encode_words_device(torch.from_numpy(data)).numpy()
    full = np.concatenate([data, par], axis=1)
    full_t = torch.from_numpy(full)
    for erased in erasure_sets(n, m):
        avail = [c for c in range(n) if c not in erased]
        got = port.decode_words_device(avail, full_t[:, avail], erased)
        want = ref_np(ref.decode_words_device(avail, full[:, avail], erased),
                      np.int32)
        assert np.array_equal(got.numpy(), want), erased
        assert np.array_equal(want, full[:, erased]), erased


@pytest.mark.parametrize("technique,k,m", CASES)
def test_decode_chunks_every_erasure_set(technique, k, m):
    port, ref = codecs(technique, k, m)
    n = k + m
    data = np.random.default_rng(13).integers(0, 256, size=(k, CHUNK),
                                              dtype=np.uint8)
    full = np.concatenate([data, port.encode_chunks(data)])
    for erased in erasure_sets(n, m):
        avail = [c for c in range(n) if c not in erased]
        got = port.decode_chunks(avail, full[avail], erased)
        want = ref_np(ref.decode_chunks(avail, full[avail], erased),
                      np.uint8)
        assert np.array_equal(got, want), erased
        assert np.array_equal(got, full[erased]), erased


@pytest.mark.parametrize("technique,k,m", CASES)
def test_minimum_to_decode(technique, k, m):
    port, ref = codecs(technique, k, m)
    n = k + m
    for erased in erasure_sets(n, m):
        avail = set(range(n)) - set(erased)
        for want in (set(range(k)), {erased[0]}, set(erased)):
            assert port.minimum_to_decode(want, avail) == \
                ref.minimum_to_decode(want, avail), (want, avail)


@pytest.mark.parametrize("technique,k,m", CASES)
def test_host_encode_decode_api(technique, k, m):
    port, ref = codecs(technique, k, m)
    n = k + m
    blob = np.random.default_rng(14).integers(
        0, 256, size=1000, dtype=np.uint8).tobytes()
    got = port.encode(set(range(n)), blob)
    want = ref.encode(set(range(n)), blob)
    assert sorted(got) == sorted(want) == list(range(n))
    for c in range(n):
        assert np.array_equal(got[c], ref_np(want[c], np.uint8)), c
    size = len(got[0])
    for erased in ([0], [k - 1, k], list(range(n - m, n))):
        have = {c: got[c] for c in range(n) if c not in erased}
        dec = port.decode(set(range(k)), have, size)
        dec_ref = ref.decode(set(range(k)), have, size)
        for c in range(k):
            assert np.array_equal(dec[c], ref_np(dec_ref[c], np.uint8))
            assert np.array_equal(dec[c], got[c])


@pytest.mark.parametrize("k,m", [(4, 2), (8, 3)])
def test_corpus_bytes_pinned(k, m):
    corpus = np.load(CORPUS)
    codec = instance().factory("jax", profile_for("jax", "bitsliced", k, m),
                               device="cpu")
    n = codec.get_chunk_count()
    chunks = codec.encode(set(range(n)), payload())
    for c in range(n):
        assert np.array_equal(chunks[c],
                              corpus[f"jax.bitsliced.k{k}m{m}.c{c}"]), c


@pytest.mark.cuda
def test_ec_kernel_xla_on_a_cuda_tensor_raises():
    """``ec_kernel=xla`` names the plain GF(2^8) product, which never runs
    on the card: a byte-layout codec on a CUDA tensor refuses it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ceph_tpu_torch.common.options import config
    codec = instance().factory("jax", bytes_profile("reed_sol_van", 4, 2),
                               device="cuda")
    config().set("ec_kernel", "xla")
    try:
        with pytest.raises(ErasureCodeError, match="never runs on the card"):
            codec.encode_chunks_device(
                torch.zeros((1, 4, 64), dtype=torch.uint8, device="cuda"))
    finally:
        config().clear("ec_kernel")


# ------------------------------------------------------- layout=bytes ---

def bytes_profile(technique, k, m):
    return {"k": str(k), "m": str(m), "layout": "bytes",
            "technique": technique}


@functools.lru_cache(maxsize=None)
def bytes_codecs(technique, k, m):
    prof = bytes_profile(technique, k, m)
    return (instance().factory("jax", dict(prof), device="cpu"),
            ref_instance().factory("jax", dict(prof)))


@pytest.mark.parametrize("technique,k,m", CASES)
def test_bytes_encode_chunks(technique, k, m):
    port, ref = bytes_codecs(technique, k, m)
    assert port.layout == "bytes" and port.get_profile() == ref.get_profile()
    rng = np.random.default_rng(20)
    data = rng.integers(0, 256, size=(k, 37), dtype=np.uint8)
    got = port.encode_chunks(data)
    assert got.dtype == np.uint8 and got.shape == (m, 37)
    assert np.array_equal(got, ref_np(ref.encode_chunks(data), np.uint8))
    batch = rng.integers(0, 256, size=(3, k, CHUNK), dtype=np.uint8)
    assert np.array_equal(port.encode_chunks_batch(batch),
                          ref_np(ref.encode_chunks_batch(batch), np.uint8))


@pytest.mark.parametrize("technique,k,m", CASES)
def test_bytes_decode_chunks_every_erasure_set(technique, k, m):
    port, ref = bytes_codecs(technique, k, m)
    n = k + m
    data = np.random.default_rng(21).integers(0, 256, size=(2, k, CHUNK),
                                              dtype=np.uint8)
    full = np.concatenate([data, port.encode_chunks_batch(data)], axis=1)
    for erased in erasure_sets(n, m):
        avail = [c for c in range(n) if c not in erased]
        got = port.decode_chunks_batch(avail, full[:, avail], erased)
        want = ref_np(ref.decode_chunks_batch(avail, full[:, avail], erased),
                      np.uint8)
        assert np.array_equal(got, want), erased
        assert np.array_equal(got, full[:, erased]), erased


@pytest.mark.parametrize("technique,k,m", CASES)
def test_bytes_minimum_to_decode(technique, k, m):
    port, ref = bytes_codecs(technique, k, m)
    n = k + m
    for erased in erasure_sets(n, m):
        avail = set(range(n)) - set(erased)
        for want in (set(range(k)), set(erased)):
            assert port.minimum_to_decode(want, avail) == \
                ref.minimum_to_decode(want, avail), (want, avail)


@pytest.mark.parametrize("technique,k,m", [
    ("reed_sol_van", 4, 2), ("reed_sol_van", 8, 3), ("cauchy", 4, 2),
    ("cauchy_good", 6, 3), ("isa_rs", 8, 4)])
def test_bytes_corpus_pinned(technique, k, m):
    """The pinned jax.<technique> entries: profiles that name no layout
    get the codec's own default, bytes."""
    corpus = np.load(CORPUS)
    codec = instance().factory("jax", profile_for("jax", technique, k, m),
                               device="cpu")
    assert codec.layout == "bytes"
    n = codec.get_chunk_count()
    chunks = codec.encode(set(range(n)), payload())
    for c in range(n):
        assert np.array_equal(
            chunks[c], corpus[f"jax.{technique}.k{k}m{m}.c{c}"]), c


def test_bytes_layout_refuses_the_word_domain():
    port, _ = bytes_codecs("reed_sol_van", 4, 2)
    with pytest.raises(ErasureCodeError, match="bitsliced"):
        port.encode_words_device(torch.zeros((1, 4, 8), dtype=torch.int32))
    with pytest.raises(ErasureCodeError, match="bitsliced"):
        port.decode_words_device([0, 1, 2, 3], torch.zeros(
            (1, 4, 8), dtype=torch.int32), [4])


def test_ec_kernel_xla_on_the_cpu_runs_the_plain_version():
    from ceph_tpu_torch.common.options import config
    from ceph_tpu_torch.ops import gf_pallas
    port, ref = bytes_codecs("cauchy", 4, 2)
    data = np.random.default_rng(22).integers(0, 256, size=(2, 4, 40),
                                              dtype=np.uint8)
    want = ref_np(ref.encode_chunks_batch(data), np.uint8)
    runs = gf_pallas.plain_runs
    assert np.array_equal(port.encode_chunks_batch(data), want)
    assert gf_pallas.plain_runs == runs + 1
    config().set("ec_kernel", "xla")
    try:
        assert np.array_equal(port.encode_chunks_batch(data), want)
    finally:
        config().clear("ec_kernel")
    assert gf_pallas.plain_runs == runs + 1     # xla: gf8_matmul directly
    with pytest.raises(ErasureCodeError):
        instance().factory("jax", {"k": "4", "m": "2", "layout": "bogus"},
                           device="cpu")


def test_registry_has_only_the_jax_plugin():
    """The registry names exactly the reference's six builtins (the name
    is kept from when ``jax`` was the only one); an unknown name still
    raises."""
    assert instance().names() == ref_instance().names() == \
        ["clay", "isa", "jax", "jerasure", "lrc", "shec"]
    with pytest.raises(ErasureCodeError, match="unknown"):
        instance().factory("no_such_plugin", {"k": "4", "m": "2"},
                           device="cpu")
