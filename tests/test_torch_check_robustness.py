"""The port's check_robustness against ceph_tpu's.

``ceph_tpu_torch/tools/check_robustness.py`` is the twin of
``scripts/check_robustness.py``.  As tests/test_crashdev.py
::test_crash_smoke_script_checks runs the reference's, the twin's
CrashDev smoke runs here in-process; then the seeded soak
(``run_once(5)``) in both packages, the port's on the CPU: the same
schedule and the same fire counts; and the twin's whole ``main``.
"""
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu_torch.tools import check_robustness
from torch_check import reference_smoke

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)


@pytest.fixture
def on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


def test_crash_smoke_script_checks(tmp_path):
    """::test_crash_smoke_script_checks"""
    assert check_robustness.run_crash_smoke(str(tmp_path)) == 0


def test_run_once_schedule_and_fires_equal_the_reference(on_cpu):
    """``run_once(5)``: the thrash schedule and the fire counts are the
    reference's, and the soak holds every invariant."""
    port = check_robustness.run_once(5)
    ref = reference_smoke("robustness").run_once(5)
    assert port["schedule"] == ref["schedule"]
    assert port["fire_counts"] == ref["fire_counts"]
    assert port["ok"], port["failures"]
    assert port["fire_counts"] and min(port["fire_counts"].values()) >= 1


def test_check_robustness_main(capsys):
    assert check_robustness.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "schedule reproducible; netsplit:" in out
    assert "epochs linear, health HEALTH_OK" in out
