"""The port's layered and non-MDS codecs (lrc, shec, clay) against
ceph_tpu's.

One profile dict builds both codecs; the same NumPy inputs (from
``np.random.default_rng``) go through both, on the CPU, and every result
must be bit-identical.  LRC's layers and CLAY's ``mds`` and ``pft`` are
the ``jax`` plugin in its byte layout, so each of their stripe operations
is one trip through kernel K2's wrapper, which takes its plain version on
a CPU tensor.  Covers, per codec:

  * parity matrices (SHEC) and layer maps (LRC) and CLAY's geometry;
  * ``encode_chunks`` and ``encode_chunks_batch``;
  * ``decode_chunks`` and its batch form for every erasure set up to m
    (LRC and SHEC: every set up to n - k, where both packages must
    agree on which ones they can recover; the widest profiles: every
    single erasure and a seeded sample of larger sets);
  * ``minimum_to_decode`` plans, CLAY's ``SubChunkPlan`` ranges and its
    ``repair`` bytes from d helpers;
  * the pinned corpus bytes;
  * the device of the inner codecs, which must be the outer codec's;
  * the factory's error cases.
"""
import functools
import itertools
import json
import os
import sys

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.ec import instance as ref_instance
from ceph_tpu.ec.interface import ErasureCodeError as RefErasureCodeError
from ceph_tpu_torch.common.perf_counters import perf
from ceph_tpu_torch.ec import instance
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ops import gf_pallas

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "scripts"))
from gen_ec_corpus import payload, profile_for  # noqa: E402

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(__file__), "golden",
                      "ec_corpus.npz")
EXPLICIT_LRC = {"mapping": "__DD__DD", "layers": json.dumps(
    [["_cDD_cDD", ""], ["cDDD____", ""], ["____cDDD", ""]])}
PROFILES = {
    "lrc-k4m2l3": ("lrc", {"k": "4", "m": "2", "l": "3"}),
    "lrc-k6m3l3": ("lrc", {"k": "6", "m": "3", "l": "3"}),
    "lrc-explicit": ("lrc", EXPLICIT_LRC),
    "shec-k4m3c2": ("shec", {"k": "4", "m": "3", "c": "2"}),
    "shec-k6m3c2": ("shec", {"k": "6", "m": "3", "c": "2"}),
    "shec-k4m3c2-single": ("shec", {"k": "4", "m": "3", "c": "2",
                                    "technique": "single"}),
    "shec-k8m4c3": ("shec", {"k": "8", "m": "4", "c": "3"}),
    "clay-k4m2d5": ("clay", {"k": "4", "m": "2", "d": "5"}),
    "clay-k3m3d4": ("clay", {"k": "3", "m": "3", "d": "4"}),
    "clay-k5m4d6": ("clay", {"k": "5", "m": "4", "d": "6"}),
    "clay-k8m4d11": ("clay", {"k": "8", "m": "4", "d": "11"}),
}
# the wide codecs decode every single erasure and this many seeded sets
# of each larger size (every set of theirs would take minutes)
WIDE = {"lrc-k6m3l3", "shec-k8m4c3", "clay-k5m4d6", "clay-k8m4d11"}
WIDE_SAMPLE = 4


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


@functools.lru_cache(maxsize=None)
def codecs(name):
    plugin, prof = PROFILES[name]
    return (instance().factory(plugin, dict(prof), device="cpu"),
            ref_instance().factory(plugin, dict(prof)))


def full_stripes(name, n_stripes, seed):
    """[n_stripes, n, chunk]: seeded data chunks and the port's parity."""
    port, _ = codecs(name)
    k = port.get_data_chunk_count()
    chunk = port.get_chunk_size(k * 64)
    data = np.random.default_rng(seed).integers(
        0, 256, size=(n_stripes, k, chunk), dtype=np.uint8)
    return np.concatenate([data, port.encode_chunks_batch(data)], axis=1)


def erasure_sets(name):
    """Every erasure set the test decodes for ``name``: up to m for CLAY,
    up to n - k for LRC and SHEC (not all of them recoverable)."""
    port, _ = codecs(name)
    n, k, m = port.get_chunk_count(), port.get_data_chunk_count(), \
        port.get_coding_chunk_count()
    top = m if name.startswith("clay") else n - k
    by_size = {r: [list(e) for e in itertools.combinations(range(n), r)]
               for r in range(1, top + 1)}
    if name not in WIDE:
        return [e for r in by_size for e in by_size[r]]
    rng = np.random.default_rng(40)
    return by_size[1] + [
        by_size[r][i] for r in range(2, top + 1)
        for i in sorted(rng.choice(len(by_size[r]), WIDE_SAMPLE,
                                   replace=False))]


def outcome(fn):
    """(bytes or None, error text or None) of one call."""
    try:
        return np.asarray(fn(), dtype=np.uint8), None
    except (ErasureCodeError, RefErasureCodeError) as e:
        return None, str(e)


@pytest.mark.parametrize("name", list(PROFILES))
def test_layered_structure_equals_reference(name):
    port, ref = codecs(name)
    assert port.get_profile() == ref.get_profile()
    assert port.get_chunk_count() == ref.get_chunk_count()
    assert port.get_data_chunk_count() == ref.get_data_chunk_count()
    assert port.get_sub_chunk_count() == ref.get_sub_chunk_count()
    assert port.get_chunk_mapping() == ref.get_chunk_mapping()
    for width in (1, 4096, 100_000):
        assert port.get_chunk_size(width) == ref.get_chunk_size(width)
    plugin = PROFILES[name][0]
    if plugin == "lrc":
        assert port.mapping == ref.mapping
        assert [(a.chunks_map, a.profile) for a in port.layers] == \
            [(b.chunks_map, b.profile) for b in ref.layers]
        for a, b in zip(port.layers, ref.layers):
            assert np.array_equal(a.codec.parity, np.asarray(b.codec.parity))
    elif plugin == "shec":
        assert np.array_equal(port.parity, ref.parity)
    else:
        assert (port.q, port.t, port.nu, port.d) == \
            (ref.q, ref.t, ref.nu, ref.d)
        for inner in ("mds", "pft"):
            assert np.array_equal(getattr(port, inner).parity,
                                  np.asarray(getattr(ref, inner).parity))


@pytest.mark.parametrize("name", list(PROFILES))
def test_layered_encode_equals_reference(name):
    port, ref = codecs(name)
    full = full_stripes(name, 2, seed=41)
    k = port.get_data_chunk_count()
    data = full[:, :k]
    assert np.array_equal(full[:, k:],
                          np.asarray(ref.encode_chunks_batch(data)))
    for s in range(2):
        assert np.array_equal(port.encode_chunks(data[s]),
                              np.asarray(ref.encode_chunks(data[s])))


@pytest.mark.parametrize("name", list(PROFILES))
def test_layered_decode_every_erasure_set(name):
    port, ref = codecs(name)
    n = port.get_chunk_count()
    full = full_stripes(name, 2, seed=42)
    recovered = 0
    for erased in erasure_sets(name):
        avail = [c for c in range(n) if c not in erased]
        got, got_err = outcome(lambda: port.decode_chunks(
            avail, full[0, avail], erased))
        want, want_err = outcome(lambda: ref.decode_chunks(
            avail, full[0, avail], erased))
        assert got_err == want_err, erased
        if want is None:
            continue
        recovered += 1
        assert np.array_equal(got, want), erased
        assert np.array_equal(got, full[0, erased]), erased
    assert recovered > 0
    # the batch form over one shared signature
    erased = erasure_sets(name)[-1 if name.startswith("clay") else 0]
    avail = [c for c in range(n) if c not in erased]
    got = port.decode_chunks_batch(avail, full[:, avail], erased)
    assert np.array_equal(got, np.asarray(
        ref.decode_chunks_batch(avail, full[:, avail], erased)))
    assert np.array_equal(got, full[:, erased])


def plan_or_error(codec, want, avail):
    try:
        return codec.minimum_to_decode(want, avail), None
    except (ErasureCodeError, RefErasureCodeError) as e:
        return None, str(e)


@pytest.mark.parametrize("name", list(PROFILES))
def test_layered_minimum_to_decode_equals_reference(name):
    port, ref = codecs(name)
    n, k = port.get_chunk_count(), port.get_data_chunk_count()
    for erased in erasure_sets(name):
        avail = set(range(n)) - set(erased)
        for want in (set(range(k)), set(erased), {erased[0]}):
            assert plan_or_error(port, want, avail) == \
                plan_or_error(ref, want, avail), (want, avail)


@pytest.mark.parametrize("name", [n for n in PROFILES
                                  if n.startswith("clay")])
def test_clay_repair_from_d_helpers_equals_reference(name):
    """Every single lost chunk: the plan (helpers and their sub-chunk
    ranges), ``is_repair`` and the repaired bytes equal the reference's
    and the lost chunk; with d < n - 1 also with an aloof node."""
    port, ref = codecs(name)
    n = port.get_chunk_count()
    full = full_stripes(name, 1, seed=43)[0]
    sub = port.get_sub_chunk_count()
    chunk = full.shape[-1]
    sc = chunk // sub
    cases = [(lost, set(range(n)) - {lost}) for lost in range(n)]
    if port.d < n - 1:
        cases += [(lost, set(range(n)) - {lost, (lost + 1) % n})
                  for lost in range(n)]
    repaired = 0
    for lost, avail in cases:
        assert port.is_repair({lost}, avail) == ref.is_repair({lost}, avail)
        assert port.get_repair_subchunks(lost) == \
            ref.get_repair_subchunks(lost)
        plan = port.minimum_to_decode({lost}, avail)
        assert plan == ref.minimum_to_decode({lost}, avail), (lost, avail)
        if not port.is_repair({lost}, avail):
            continue
        assert len(plan) == port.d
        helpers = {h: np.concatenate([full[h].reshape(sub, sc)[o:o + c]
                                      for o, c in rg]).reshape(-1)
                   for h, rg in plan.items()}
        assert all(v.size == chunk // port.q for v in helpers.values())
        got = port.repair(lost, helpers, chunk)
        assert np.array_equal(got, np.asarray(ref.repair(lost, helpers,
                                                         chunk)))
        assert np.array_equal(got, full[lost]), lost
        repaired += 1
    assert repaired >= n


@pytest.mark.parametrize("plugin,k,m", [("shec", 4, 3), ("lrc", 4, 2),
                                        ("clay", 4, 2)])
def test_layered_corpus_bytes_pinned(plugin, k, m):
    corpus = np.load(CORPUS)
    codec = instance().factory(plugin, profile_for(plugin, None, k, m),
                               device="cpu")
    n = codec.get_chunk_count()
    chunks = codec.encode(set(range(n)), payload())
    for c in range(n):
        assert np.array_equal(chunks[c],
                              corpus[f"{plugin}.default.k{k}m{m}.c{c}"]), c


@pytest.mark.parametrize("name", ["lrc-k4m2l3", "clay-k4m2d5"])
def test_inner_codecs_are_built_on_the_outer_codecs_device(name):
    """The package default stays ``cuda`` here: an inner codec built
    without the outer codec's device would resolve ``cuda`` and raise on
    a machine without a card, and sit on the card on one with it."""
    plugin, prof = PROFILES[name]
    assert ceph_tpu_torch.default_device() == "cpu"
    ceph_tpu_torch.set_default_device("cuda")
    codec = instance().factory(plugin, dict(prof), device="cpu")
    inner = [lay.codec for lay in codec.layers] if plugin == "lrc" else \
        [codec.mds, codec.pft]
    assert codec.device == torch.device("cpu")
    assert [c.device for c in inner] == [codec.device] * len(inner)
    # every stripe operation of an inner codec is one trip through K2's
    # wrapper and one ec.jax dispatch
    pc = perf("ec.jax")

    def snap():
        d = pc.dump()
        return (gf_pallas.plain_runs, d.get("encode_dispatches", 0) +
                d.get("decode_dispatches", 0))

    before = snap()
    full = full_stripes(name, 1, seed=44)[0]
    n = codec.get_chunk_count()
    avail = [c for c in range(n) if c != 0]
    assert np.array_equal(codec.decode_chunks(avail, full[avail], [0]),
                          full[[0]])
    runs, dispatches = (a - b for a, b in zip(snap(), before))
    assert runs == dispatches > 0


def test_layered_codec_without_a_card_raises_unless_the_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("the card is present: the default device resolves")
    ceph_tpu_torch.set_default_device("cuda")
    for plugin, prof in PROFILES.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            instance().factory(plugin, dict(prof))


@pytest.mark.parametrize("prof", [
    {"k": "4", "m": "2", "l": "3", "crush-locality": "rack",
     "crush-failure-domain": "host"},
    {"k": "4", "m": "2", "l": "3"}])
def test_lrc_crush_rule_equals_reference(prof):
    from ceph_tpu.ec.plugin_lrc import lrc_crush_rule as ref_rule
    from ceph_tpu.placement.builder import build_flat_cluster as ref_build
    from ceph_tpu_torch.ec.plugin_lrc import lrc_crush_rule
    from ceph_tpu_torch.placement.builder import build_flat_cluster
    port = instance().factory("lrc", dict(prof), device="cpu")
    ref = ref_instance().factory("lrc", dict(prof))
    cmap, _ = build_flat_cluster(n_hosts=9, osds_per_host=2, n_racks=3)
    rcmap, _ = ref_build(n_hosts=9, osds_per_host=2, n_racks=3)
    got = cmap.rules[lrc_crush_rule(port, cmap)]
    want = rcmap.rules[ref_rule(ref, rcmap)]
    assert [tuple(s) for s in got.steps] == [tuple(s) for s in want.steps]
    assert (got.name, got.type) == (want.name, want.type)


@pytest.mark.parametrize("plugin,profile", [
    ("lrc", {"k": "4", "m": "2", "l": "5"}),
    ("lrc", {"k": "4", "m": "2", "l": "0"}),
    ("lrc", {"k": "3", "m": "3", "l": "3"}),
    ("lrc", {"mapping": "DD", "layers": "not json"}),
    ("lrc", {"mapping": "DD", "layers": "[]"}),
    ("lrc", {"mapping": "DDDD", "layers": '[["Dc", ""]]'}),
    ("lrc", {"mapping": "DDc", "layers": '[["DD_", ""]]'}),
    ("shec", {"k": "13", "m": "3", "c": "2"}),
    ("shec", {"k": "12", "m": "12", "c": "2"}),
    ("shec", {"k": "4", "m": "5", "c": "2"}),
    ("shec", {"k": "4", "m": "3", "c": "4"}),
    ("shec", {"k": "4", "m": "3", "c": "2", "technique": "nope"}),
    ("clay", {"k": "4", "m": "2", "d": "6"}),
    ("clay", {"k": "4", "m": "2", "d": "3"}),
    ("clay", {"k": "4", "m": "2", "scalar_mds": "nope"}),
    ("clay", {"k": "1", "m": "2"})])
def test_layered_factory_errors_match_reference(plugin, profile):
    with pytest.raises(RefErasureCodeError) as ref_err:
        ref_instance().factory(plugin, dict(profile))
    with pytest.raises(ErasureCodeError) as port_err:
        instance().factory(plugin, dict(profile), device="cpu")
    assert str(port_err.value) == str(ref_err.value)
