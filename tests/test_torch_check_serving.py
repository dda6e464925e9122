"""The port's check_serving, as tests/test_s3_serving.py
::test_check_serving_smoke runs the reference's.

``ceph_tpu_torch/tools/check_serving.py`` (the twin of
``scripts/check_serving.py``): its sharding leg in-process on an RS(2,1)
sim of the CPU, as the reference's test runs it; then the whole check
(the live gate green and ``--starve`` red over three OSD daemons) in a
child process with a timeout, since the serve path can hang (ROADMAP
section C).
"""
import torch

import ceph_tpu_torch
from ceph_tpu_torch.tools import check_serving
from torch_check import run_twin

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)


def test_check_serving_smoke(capsys):
    """::test_check_serving_smoke"""
    with ceph_tpu_torch.using_device("cpu"):
        assert check_serving._check_sharding_semantics() == 0
    assert "entries per shard [5, 5, 5, 5, 5, 5, 5, 5]" in \
        capsys.readouterr().out


def test_check_serving_live_legs():
    r = run_twin("serving", timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "gate green: " in r.stdout
    assert "falsifiability ok: starved config exits nonzero" in r.stdout
    assert r.stdout.rstrip().endswith("check_serving: OK")
