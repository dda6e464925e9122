"""cephtpu-lint entry point for the port — the static-analysis CI gate.

The twin of ``scripts/lint.py``: a thin wrapper over
``ceph_tpu_torch.analysis.runner`` (also surfaced as ``ceph_tpu_torch.
tools.ceph_cli lint``) that lints ``ceph_tpu_torch/`` and the port's
root scripts, with the port's own tests as evidence.  Typical
invocations::

    python -m ceph_tpu_torch.tools.lint                 # report
    python -m ceph_tpu_torch.tools.lint --check         # CI gate: exit
                                                        # 1 on any
                                                        # unsuppressed
                                                        # finding OR
                                                        # stale baseline
                                                        # entry
    python -m ceph_tpu_torch.tools.lint --json          # machine-readable
    python -m ceph_tpu_torch.tools.lint --sarif         # SARIF 2.1.0
    python -m ceph_tpu_torch.tools.lint --select CTL1   # one family
    python -m ceph_tpu_torch.tools.lint --rule CTL8     # same
    python -m ceph_tpu_torch.tools.lint --graph xor_kernel._launch
                                                        # call-graph dump
    python -m ceph_tpu_torch.tools.lint --list-rules
    python -m ceph_tpu_torch.tools.lint --write-baseline

Suppression: inline ``# noqa: CTL###`` next to a deliberate exception
(preferred), or an entry in ``ceph_tpu_torch/tools/lint_baseline.json``.
``tests/test_torch_lint.py`` runs the equivalent of ``--check`` on every
pytest run.
"""
from ..analysis.runner import main

if __name__ == "__main__":
    raise SystemExit(main())
