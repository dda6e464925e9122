"""``ceph_tpu_torch.entry.entry()`` against ``__graft_entry__.entry()``:
the same example inputs, and the same parity words from the port's K1
wrapper (its plain version, on the CPU) as from the reference's
``xor_matmul_w32`` — bit-identical."""
import numpy as np
import torch

import __graft_entry__
from ceph_tpu_torch import entry

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)


def test_entry_inputs_equal_reference():
    fn, (masks, words) = entry.entry()
    rfn, (rmasks, rwords) = __graft_entry__.entry()
    assert fn.__name__ == rfn.__name__ == "xor_matmul_w32"
    assert masks.dtype == rmasks.dtype and np.array_equal(masks, rmasks)
    assert words.dtype == rwords.dtype and np.array_equal(words, rwords)


def test_entry_parity_equals_reference():
    fn, (masks, words) = entry.entry()
    got = fn(torch.from_numpy(masks), torch.from_numpy(words))
    rfn, (rmasks, rwords) = __graft_entry__.entry()
    want = np.asarray(rfn(rmasks, rwords))
    assert got.dtype == torch.int32 and tuple(got.shape) == (16, 24, 512)
    assert np.array_equal(got.numpy(), want)
