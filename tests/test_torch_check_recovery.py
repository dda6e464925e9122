"""The port's check_recovery against ceph_tpu's.

``ceph_tpu_torch/tools/check_recovery.py`` is the twin of
``scripts/check_recovery.py`` (run whole by tests/test_process_cluster.py
::test_check_recovery_script).  The twin runs whole on the CPU, in a
child process with a timeout (its process tier starts three OSD
daemons); its sim tier's deterministic facts (the OSD lost, the shards
rebuilt and copied) must be the reference's sim tier's.
"""
import re

import torch

from torch_check import reference_smoke, run_twin

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

SIM_TIER = re.compile(r"^sim tier ok: osd\.(\d+) rebuilt \((\d+) rebuilt / "
                      r"(\d+) copied\), zero loss", re.M)


def test_check_recovery_script(capsys):
    """::test_check_recovery_script, its sim tier held to the
    reference's"""
    r = run_twin("recovery", timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "process tier ok: zero loss, reservations consistent" in r.stdout
    assert r.stdout.rstrip().endswith("check_recovery: OK")
    port = SIM_TIER.search(r.stdout)
    assert reference_smoke("recovery")._check_sim_tier() == 0
    ref = SIM_TIER.search(capsys.readouterr().out)
    assert port and ref and port.groups() == ref.groups()
    assert int(port.group(2)) > 0
