"""The port's check_observability, as tests/test_op_tracker.py
::test_check_observability_script runs the reference's.

``ceph_tpu_torch/tools/check_observability.py`` (the twin of
``scripts/check_observability.py``, less its leg 10, the JAX package's
bench snapshots) in-process on the CPU: the op trail, the stage
histograms, both Prometheus scrapes, the slow trace, disarmed tracing,
the telemetry history, a cold operand's ``jit.compile`` span and the
balancer advisor.
"""
import torch

from ceph_tpu_torch.common.op_tracker import tracker
from ceph_tpu_torch.tools import check_observability

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)


def test_check_observability_script(capsys):
    """::test_check_observability_script"""
    tracker().reset()
    assert check_observability.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("OK: 8 tracked ops, per-stage histograms live")
    assert "jit.compile span(s)" in out


def test_check_metrics_payload_catches_a_broken_family():
    good = ('# TYPE f histogram\nf_bucket{le="1"} 1\n'
            'f_bucket{le="+Inf"} 2\nf_count 2\n')
    assert check_observability.check_metrics_payload(good, "f") == ""
    bad = good.replace("f_count 2", "f_count 3")
    assert "!= _count 3" in check_observability.check_metrics_payload(
        bad, "f")
    assert "not cumulative" in check_observability.check_metrics_payload(
        good.replace('le="1"} 1', 'le="1"} 5'), "f")
