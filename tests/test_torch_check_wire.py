"""The port's check_wire, as tests/test_wire_zero.py
::test_check_wire_smoke runs the reference's.

``ceph_tpu_torch/tools/check_wire.py`` (the twin of
``scripts/check_wire.py``) end to end on the CPU, in a child process with
a timeout: two OSD daemons of the port, one crc pass per byte counted by
the ``wire.zero`` scan hook, the shm lane negotiated and carrying the
payload, the socket fallback with the ring disabled.
"""
import torch

from torch_check import run_twin

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)


def test_check_wire_smoke():
    """::test_check_wire_smoke"""
    r = run_twin("wire", timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("OK: ZeroWire verified (verify="), r.stdout
    assert "store=0 trusted=4194304B shm_moved=2097152B" in r.stdout
