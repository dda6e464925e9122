"""cephtpu-lint for the port — AST-based static analysis of
``ceph_tpu_torch`` for the framework's own invariants.

The twin of ``ceph_tpu/analysis``: the same substrate (parsed modules,
rule registry, ``# noqa: CTL###`` suppression, the checked-in baseline,
the whole-program import-resolving call graph of
``astutil.ProgramGraph``), the same backend-free rule families copied
as they are, and torch counterparts of the reference's JAX-shaped
rules.  The reference's one jit-reachable ("hot") set becomes two
(analysis/astutil.py): the device-path set (the host code around the
card's kernels, where a host sync drains the launch queue) and the
capture set (code a CUDA graph captures, whose host work runs once).
Rule ids are the reference's:

  CTL1xx  device-path hygiene: host syncs (101), branches on a tensor's
          value (102) and per-call kernel/compile builds (103) on the
          device path; the messenger (110: blocking calls reachable
          from completion-callback context) and recovery loops (120:
          per-shard blocking round trips, helpers included)
  CTL13x  wire hot-path copies and reply rescans
  CTL2xx  GF(2^8)/CRUSH dtype invariants (torch's int64/float32
          constructor defaults; unpinned tensor ingestion in ops/)
  CTL3xx  concurrency (static lock-order inversions against the same
          edge model common/lockdep.py enforces at runtime; raw
          threading locks in daemon-plane modules)
  CTL4xx  perf-counter / config registry hygiene
  CTL5xx  admin-command registry (dispatched vs registered)
  CTL6xx  faultpoint registry closure (fires declared; fires in the
          capture set; swallowed IO errors; store writes off the
          barrier API; markers before completion)
  CTL7xx  trace-context propagation closure
  CTL8xx  wire-protocol contract closure
  CTL9xx  serving paths (whole-index reads on a request path)
  CTL10xx mesh legs and collectives (``torch.distributed`` peers and
          groups, capture-time effects, per-cell syncs, literal splits,
          unreduced per-cell counts, rank-branch deadlocks)

Entry points: ``python -m ceph_tpu_torch.tools.lint`` (CI gate),
``ceph_tpu_torch.tools.ceph_cli lint`` (operator surface),
``ceph_tpu_torch.analysis.runner.run`` (library),
``python -m ceph_tpu_torch.tools.check_static`` (seeded smoke).
"""
from .core import Finding, LintError, Rule  # noqa: F401
from .registry import RuleRegistry, instance  # noqa: F401
from .runner import run  # noqa: F401
