"""The port's batched rjenkins hashes against ceph_tpu's and the golden
vectors (tests/golden/hash_vectors.json, from the reference's C hash).

The port computes in int64 holding u32 values; every comparison casts
both sides to int64 and is exact."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ops import hashing as ref
from ceph_tpu_torch.ops import hashing as port

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "hash_vectors.json")
EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint32)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def operands(n_args, seed):
    """n_args u32 operand vectors: the edge values crossed with random
    ones (np.random.default_rng(seed))."""
    rng = np.random.default_rng(seed)
    n = 512
    cols = [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
            for _ in range(n_args)]
    for i, c in enumerate(cols):        # every edge in every position
        c[:len(EDGES)] = np.roll(EDGES, i)
    return cols


def as_port(a):
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("arity", [2, 3, 4])
def test_batched_hash_equals_reference(arity):
    cols = operands(arity, seed=arity)
    want = np.asarray(getattr(ref, f"jx_hash{arity}")(
        *[jnp.asarray(c) for c in cols])).astype(np.int64)
    got = getattr(port, f"jx_hash{arity}")(*[as_port(c) for c in cols])
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("arity", [2, 3, 4])
def test_batched_hash_equals_golden(golden, arity):
    """Operand layout of tests/test_hashing.py: a = inputs[i], then
    inputs[i+7], inputs[i+13], inputs[i+19] (mod n)."""
    xs = np.asarray(golden["inputs"], dtype=np.uint32)
    assert {0, 2**31, 2**32 - 1} <= set(xs.tolist())
    n = len(xs)
    args = [xs[(np.arange(n) + off) % n] for off in (0, 7, 13, 19)[:arity]]
    got = getattr(port, f"jx_hash{arity}")(*[as_port(a) for a in args])
    assert got.tolist() == golden[f"h{arity}"]


def test_signed_and_narrow_operands_hash_as_u32():
    """Bucket ids are negative int32; the hash sees their u32 bits."""
    ids = np.array([-1, -2, -1000, -(2**31)], dtype=np.int32)
    x = np.array([0, 2**31, 2**32 - 1, 7], dtype=np.uint32)
    got = port.jx_hash2(torch.from_numpy(x.astype(np.int64)),
                        torch.from_numpy(ids))
    want = port.np_hash2(x, ids.view(np.uint32)).astype(np.int64)
    assert np.array_equal(got.numpy(), want)


def test_scalar_and_string_hashes_are_the_reference_copies():
    rng = np.random.default_rng(7)
    for a, b, c in rng.integers(0, 2**32, (64, 3), dtype=np.uint64):
        a, b, c = int(a), int(b), int(c)
        assert port.hash2(a, b) == ref.hash2(a, b)
        assert port.hash3(a, b, c) == ref.hash3(a, b, c)
    for name in (b"", b"o", b"rbd_data.1234", bytes(range(40))):
        assert port.str_hash_rjenkins(name) == ref.str_hash_rjenkins(name)
