"""The port's jerasure and isa plugins, its bitmatrix codec and the RAID-6
bitmatrix constructions against ceph_tpu's.

One profile dict builds both codecs; the same NumPy inputs (from
``np.random.default_rng``) go through both, on the CPU, and every result
must be bit-identical — GF arithmetic has no tolerance.  Covers every
jerasure technique and both isa techniques at the corpus configs of
scripts/gen_ec_corpus.py: parity matrices and bitmatrices, decode
matrices for every erasure set up to m, ``encode_chunks`` and its batch
form, ``decode_chunks`` and its batch form for every erasure set up to
m, ``minimum_to_decode`` plans, the pinned corpus bytes, the codec's
device, and the factory's error cases.  The bitmatrix techniques' batch
paths go through kernel K1's wrapper, which takes its plain version on a
CPU tensor.
"""
import functools
import itertools
import os
import sys

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.ec import bitmatrix_raid6 as ref_raid6
from ceph_tpu.ec import instance as ref_instance
from ceph_tpu.ec.interface import ErasureCodeError as RefErasureCodeError
from ceph_tpu_torch.ec import bitmatrix_codec, bitmatrix_raid6, instance
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ops import xor_kernel

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "scripts"))
from gen_ec_corpus import CONFIGS, payload, profile_for  # noqa: E402

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(__file__), "golden",
                      "ec_corpus.npz")
CASES = [c for c in CONFIGS if c[0] in ("jerasure", "isa")]
IDS = [f"{p}-{t}-k{k}m{m}" for p, t, k, m in CASES]
BITMATRIX = ("liberation", "blaum_roth", "liber8tion")


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


@functools.lru_cache(maxsize=None)
def codecs(plugin, technique, k, m):
    prof = profile_for(plugin, technique, k, m)
    return (instance().factory(plugin, dict(prof), device="cpu"),
            ref_instance().factory(plugin, dict(prof)))


def erasure_sets(n, m):
    for r in range(1, m + 1):
        yield from (list(e) for e in itertools.combinations(range(n), r))


def stripes(codec, k, n_stripes, seed):
    """[n_stripes, k, chunk] seeded data at the codec's chunk geometry
    (w planes of whole int32 words for a bitmatrix code)."""
    chunk = codec.get_chunk_size(k * 96)
    return np.random.default_rng(seed).integers(
        0, 256, size=(n_stripes, k, chunk), dtype=np.uint8)


@pytest.mark.parametrize("plugin,technique,k,m", CASES, ids=IDS)
def test_plugin_matrices_equal_reference(plugin, technique, k, m):
    port, ref = codecs(plugin, technique, k, m)
    assert port.get_profile() == ref.get_profile()
    assert port.device == torch.device("cpu")
    n = k + m
    if technique in BITMATRIX:
        assert port.w == ref.w
        assert np.array_equal(port.bitmatrix, ref.bitmatrix)
        for erased in erasure_sets(n, m):
            avail = [c for c in range(n) if c not in erased]
            got, used = port.decode_bitmatrix(avail, erased)
            want, ref_used = ref.decode_bitmatrix(avail, erased)
            assert used == ref_used and np.array_equal(got, want), erased
    else:
        assert np.array_equal(port.parity, ref.parity)
        assert port.parity.dtype == ref.parity.dtype
        for erased in erasure_sets(n, m):
            avail = [c for c in range(n) if c not in erased]
            got, used = port.decode_matrix(avail, erased)
            want, ref_used = ref.decode_matrix(avail, erased)
            assert used == ref_used and np.array_equal(got, want), erased


@pytest.mark.parametrize("plugin,technique,k,m", CASES, ids=IDS)
def test_plugin_encode_equals_reference(plugin, technique, k, m):
    port, ref = codecs(plugin, technique, k, m)
    data = stripes(port, k, 3, seed=30)
    for s in range(3):
        got = port.encode_chunks(data[s])
        assert got.dtype == np.uint8 and got.shape == (m, data.shape[-1])
        assert np.array_equal(got, np.asarray(ref.encode_chunks(data[s])))
    got = port.encode_chunks_batch(data)
    assert isinstance(got, np.ndarray)
    assert np.array_equal(got, np.asarray(ref.encode_chunks_batch(data)))


@pytest.mark.parametrize("plugin,technique,k,m", CASES, ids=IDS)
def test_plugin_decode_every_erasure_set(plugin, technique, k, m):
    port, ref = codecs(plugin, technique, k, m)
    n = k + m
    data = stripes(port, k, 2, seed=31)
    full = np.concatenate([data, port.encode_chunks_batch(data)], axis=1)
    for erased in erasure_sets(n, m):
        avail = [c for c in range(n) if c not in erased]
        got = port.decode_chunks_batch(avail, full[:, avail], erased)
        want = np.asarray(ref.decode_chunks_batch(avail, full[:, avail],
                                                  erased))
        assert np.array_equal(got, want), erased
        assert np.array_equal(got, full[:, erased]), erased
        one = port.decode_chunks(avail, full[1, avail], erased)
        assert np.array_equal(
            one, np.asarray(ref.decode_chunks(avail, full[1, avail],
                                              erased))), erased


@pytest.mark.parametrize("plugin,technique,k,m", CASES, ids=IDS)
def test_plugin_minimum_to_decode_equals_reference(plugin, technique, k, m):
    port, ref = codecs(plugin, technique, k, m)
    n = k + m
    for erased in erasure_sets(n, m):
        avail = set(range(n)) - set(erased)
        for want in (set(range(k)), set(erased), {erased[0]}):
            assert port.minimum_to_decode(want, avail) == \
                ref.minimum_to_decode(want, avail), (want, avail)


@pytest.mark.parametrize("plugin,technique,k,m", CASES, ids=IDS)
def test_plugin_corpus_bytes_pinned(plugin, technique, k, m):
    corpus = np.load(CORPUS)
    port, _ = codecs(plugin, technique, k, m)
    n = port.get_chunk_count()
    chunks = port.encode(set(range(n)), payload())
    key = f"{plugin}.{technique}.k{k}m{m}"
    for c in range(n):
        assert np.array_equal(chunks[c], corpus[f"{key}.c{c}"]), c


@pytest.mark.parametrize("technique,k,w", [
    ("liberation", 2, 5), ("liberation", 5, 7), ("liberation", 7, 7),
    ("liberation", 3, 5), ("blaum_roth", 4, 4), ("blaum_roth", 6, 6),
    ("blaum_roth", 10, 10), ("liber8tion", 2, 8), ("liber8tion", 6, 8),
    ("liber8tion", 8, 8)])
def test_raid6_constructions_equal_reference(technique, k, w):
    fn = f"{technique}_bitmatrix"
    got = getattr(bitmatrix_raid6, fn)(k, w)
    want = getattr(ref_raid6, fn)(k, w)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("technique,k,w", [
    ("liberation", 4, 6), ("liberation", 8, 7), ("blaum_roth", 7, 6),
    ("blaum_roth", 3, 5), ("liber8tion", 9, 8), ("liber8tion", 4, 7)])
def test_raid6_constructions_refuse_what_the_reference_refuses(technique,
                                                               k, w):
    fn = f"{technique}_bitmatrix"
    with pytest.raises(ValueError):
        getattr(ref_raid6, fn)(k, w)
    with pytest.raises(ValueError):
        getattr(bitmatrix_raid6, fn)(k, w)


@pytest.mark.parametrize("technique,k,w", [
    ("liberation", 5, 7), ("blaum_roth", 6, 6), ("liber8tion", 6, 8)])
def test_bitmatrix_batch_paths_take_k1s_wrapper(technique, k, w):
    """Each batched encode or decode is one trip through K1's wrapper
    (its plain version on a CPU tensor) and one dispatch of the
    bitmatrix codec's module counts; the device forms return tensors on
    the data's device."""
    port, _ = codecs("jerasure", technique, k, 2)
    data = stripes(port, k, 4, seed=32)
    runs = xor_kernel.plain_runs
    e0, de0 = (bitmatrix_codec.encode_dispatches,
               bitmatrix_codec.decode_dispatches)
    par = port.encode_chunks_device(data)
    assert isinstance(par, torch.Tensor) and par.device.type == "cpu"
    assert np.array_equal(par.numpy(), port.encode_chunks_batch(data))
    full = np.concatenate([data, par.numpy()], axis=1)
    avail = [c for c in range(k + 2) if c != 1]
    dec = port.decode_chunks_device(avail, torch.from_numpy(
        np.ascontiguousarray(full[:, avail])), [1])
    assert torch.equal(dec, torch.from_numpy(full[:, [1]]))
    assert xor_kernel.plain_runs - runs == 3
    assert bitmatrix_codec.encode_dispatches - e0 == 2
    assert bitmatrix_codec.decode_dispatches - de0 == 1
    # no erasures: an empty tensor on the device, no kernel trip
    none = port.decode_chunks_device(avail, full[:, avail], [])
    assert isinstance(none, torch.Tensor)
    assert tuple(none.shape) == (4, 0, data.shape[-1])
    assert xor_kernel.plain_runs - runs == 3
    with pytest.raises(ErasureCodeError, match="not divisible"):
        port.encode_chunks_device(np.zeros((1, k, 4 * w + 4), np.uint8))


def test_bitmatrix_host_path_raises_when_the_native_build_fails(
        monkeypatch):
    """The reference's host codec swaps in its NumPy oracle when the
    native build fails; the port's lets the failure raise."""
    from ceph_tpu_torch import native_bridge

    def broken():
        raise OSError("native build failed")

    port, _ = codecs("jerasure", "liber8tion", 8, 2)
    monkeypatch.setattr(native_bridge, "lib", broken)
    data = stripes(port, 8, 1, seed=33)[0]
    with pytest.raises(OSError, match="native build failed"):
        port.encode_chunks(data)


def test_isa_xor_fast_path_equals_reference():
    port = instance().factory("isa", {"k": "5", "m": "2"}, device="cpu")
    ref = ref_instance().factory("isa", {"k": "5", "m": "2"})
    data = np.random.default_rng(34).integers(0, 256, size=(5, 64),
                                              dtype=np.uint8)
    full = np.concatenate([data, port.encode_chunks(data)])
    avail = [0, 1, 3, 4, 5, 6]
    assert port._xor_decodable(avail, [2]) and ref._xor_decodable(avail,
                                                                  [2])
    got = port.decode_chunks(avail, full[avail], [2])
    assert np.array_equal(got, np.asarray(ref.decode_chunks(
        avail, full[avail], [2])))
    assert np.array_equal(got[0], full[2])


@pytest.mark.parametrize("plugin,profile", [
    ("jerasure", {"technique": "nope"}),
    ("jerasure", {"technique": "reed_sol_van", "w": "7"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "m": "3"}),
    ("jerasure", {"technique": "cauchy_orig", "w": "16"}),
    ("jerasure", {"technique": "liberation", "k": "5", "m": "3"}),
    ("jerasure", {"technique": "liberation", "k": "5", "w": "6"}),
    ("jerasure", {"technique": "blaum_roth", "k": "9", "w": "6"}),
    ("jerasure", {"technique": "liber8tion", "k": "9"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "abc"}),
    ("isa", {"technique": "nope"}),
    ("isa", {"k": "250", "m": "10"})])
def test_plugin_factory_errors_match_reference(plugin, profile):
    with pytest.raises(RefErasureCodeError) as ref_err:
        ref_instance().factory(plugin, dict(profile))
    with pytest.raises(ErasureCodeError) as port_err:
        instance().factory(plugin, dict(profile), device="cpu")
    assert str(port_err.value) == str(ref_err.value)


def test_smoke_corpus_copy_equals_the_corpus_script():
    """chip_smoke.py keeps its own copy of the corpus payload, configs and
    profiles (it reads no script); the copy must stay the script's."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    assert chip_smoke.CORPUS_CONFIGS == CONFIGS
    assert chip_smoke.corpus_payload() == payload()
    for cfg in CONFIGS:
        assert chip_smoke.corpus_profile(*cfg) == profile_for(*cfg)
