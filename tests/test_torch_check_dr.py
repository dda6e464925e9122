"""The port's check_dr against ceph_tpu's.

``ceph_tpu_torch/tools/check_dr.py`` is the twin of
``scripts/check_dr.py``.  As tests/test_dr_drill.py::test_check_dr_smoke
runs the reference's, the twin's determinism leg runs here in-process on
zones of the CPU, and its seed-2 schedule digest must be the reference's;
then the whole check (green, and red with a lost bilog entry) in a child
process with a timeout.
"""
import re

import torch

import ceph_tpu_torch
from ceph_tpu_torch.tools import check_dr
from torch_check import reference_smoke, run_twin

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

DIGEST = re.compile(r"seed-2 schedule digest ([0-9a-f]{12}) reproduced")


def test_check_dr_smoke(capsys):
    """::test_check_dr_smoke, its digest held to the reference's"""
    with ceph_tpu_torch.using_device("cpu"):
        assert check_dr._check_determinism() == 0
    port = DIGEST.search(capsys.readouterr().out)
    assert reference_smoke("dr")._check_determinism() == 0
    ref = DIGEST.search(capsys.readouterr().out)
    assert port and ref and port.group(1) == ref.group(1)


def test_check_dr_whole():
    r = run_twin("dr", timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "drill green: " in r.stdout
    assert "falsifiability ok: seeded lost-bilog-entry fault" in r.stdout
    assert r.stdout.rstrip().endswith("check_dr: OK")
