"""The port's check_async, as tests/test_msgr_inject.py
::test_async_smoke_script_checks runs the reference's.

``ceph_tpu_torch/tools/check_async.py`` (the twin of
``scripts/check_async.py``) end to end on the CPU, in a child process
with a timeout: three OSD daemons of the port, completions and their
callback, same-object ordering, sync and async byte identity, the
``dispatched_wire`` event and ``stage_wire_to_done_s``, live streams.
"""
import torch

from torch_check import run_twin

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)


def test_async_smoke_script_checks():
    """::test_async_smoke_script_checks"""
    r = run_twin("async", timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("OK: async objecter verified ("), r.stdout
