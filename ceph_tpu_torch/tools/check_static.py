"""Static-analysis smoke check of the port — its lint verified end to
end.

The twin of ``scripts/check_static.py``.  Two tiers, both fast enough for
the smoke sweep:

  1. SEEDED tier: a throwaway fixture tree carries one deliberate
     violation per headline family — a cross-module host sync on the
     device path (CTL101: ``.item()`` in a helper that a kernel
     launcher imports, resolvable only by the whole-program graph), a
     raw daemon-plane lock (CTL302), an undeclared faultpoint fire
     (CTL601), an unstamped data-path send through a cross-module
     wrapper (CTL701), a typo'd wire cmd (CTL801), an unstamped
     mutating send (CTL802), a short send missing a handler-read key
     (CTL803), a duplicate faultpoint declare (CTL804), a literal peer
     rank in a mesh leg (CTL1001) and a per-cell count never summed
     over the cells (CTL1005).  Every seeded violation must be caught,
     or the gate is lying.

  2. REAL tier: the port's tree (``ceph_tpu_torch/`` and its root
     scripts) must be lint-clean against its committed baseline with
     ZERO stale entries, inside the 30 s wall-time budget.

Runs on the CPU:

    python -m ceph_tpu_torch.tools.check_static            # both tiers
    python -m ceph_tpu_torch.tools.check_static --quick    # seeded only

Also wired as a fast pytest test (``tests/test_torch_lint.py``).
"""
from __future__ import annotations

import os
import sys
import tempfile
import textwrap
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


# (relpath, source, expected rule ids at least once in that file)
_SEEDS = (
    ("pkg/__init__.py", "", ()),
    ("ops/__init__.py", "", ()),
    ("ops/_build.py", """
        import ctypes

        _libs = {}

        def load(name):
            if name not in _libs:
                _libs[name] = ctypes.CDLL(name + ".so")
            return _libs[name]
        """, ()),
    ("pkg/hot_helper.py", """
        def mix(y):
            return y.sum().item()
        """, ("CTL101",)),
    ("pkg/hot_entry.py", """
        from ops import _build
        from .hot_helper import mix

        def launch(x, out):
            _build.load("k").ceph_k(x.data_ptr(), out.data_ptr())
            return mix(out)
        """, ("CTL103",)),
    ("cluster/locks.py", """
        import threading
        L = threading.Lock()
        """, ("CTL302",)),
    ("cluster/fire.py", """
        from ceph_tpu_torch.common import faults

        def send():
            return faults.fire("never.declared")
        """, ("CTL601",)),
    ("cluster/wrapper.py", """
        def fanout(conn, req):
            return conn.call(req)
        """, ()),
    ("cluster/sender.py", """
        from .wrapper import fanout

        def gap(conn, coll, oid):
            # CTL701 reports at the call site handing the unstamped
            # dict to the cross-module raw-send wrapper
            return fanout(conn, {"cmd": "get_shard", "coll": coll,
                                 "oid": oid})

        def typo(conn, coll):
            return conn.osd_call(0, {"cmd": "get_shrad",
                                     "coll": coll, "oid": "o"})

        def unstamped(conn, coll, data):
            return conn.call({"cmd": "put_thing", "coll": coll,
                              "data": data, "tctx": None})

        def short(conn, coll):
            return conn.osd_call(0, {"cmd": "put_thing",
                                     "coll": coll, "tctx": None})
        """, ("CTL701", "CTL801", "CTL802", "CTL803")),
    ("cluster/daemon.py", """
        _REPLAY_CMDS = frozenset(("put_thing",))

        class Daemon:
            def _handle(self, entity, req):
                cmd = req["cmd"]
                if cmd == "put_thing":
                    return (req["coll"], req["data"])
                if cmd == "get_shard":
                    return req["oid"]
        """, ()),
    ("cluster/decl.py", """
        from ceph_tpu_torch.common import faults
        faults.declare("twice.over", "first")
        """, ()),
    ("cluster/decl2.py", """
        from ceph_tpu_torch.common import faults
        faults.declare("twice.over", "second site")
        """, ("CTL804",)),
    # mesh seeds: a literal peer rank in a leg (CTL1001) and a per-cell
    # reduction that the caller never sums over the cells (CTL1005) —
    # the two fleet bugs that run fine in one process and surface only
    # on several ranks
    ("parallel/__init__.py", "", ()),
    ("parallel/mesh.py", """
        def run_cells(mesh, fn):
            return {i: tuple(fn(i, c)) for i, c in enumerate(mesh)}
        """, ()),
    ("parallel/plane.py", """
        import torch.distributed as dist

        from .mesh import run_cells

        def step(mesh, x):
            def cell(i, c):
                reqs = dist.batch_isend_irecv(
                    [dist.P2POp(dist.isend, x, 1)])
                for r in reqs:
                    r.wait()
                return (x.sum(),)

            outs = run_cells(mesh, cell)
            return outs[0][0]
        """, ("CTL1001", "CTL1005")),
)


def _check_seeded() -> int:
    from ..analysis import runner
    with tempfile.TemporaryDirectory(prefix="ctlint-smoke-") as tmp:
        for rel, src, _want in _SEEDS:
            p = os.path.join(tmp, rel)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(p, "w", encoding="utf-8") as f:
                f.write(textwrap.dedent(src))
        res = runner.run(tmp, paths=["."], evidence_paths=[],
                         baseline=None)
        got = {}
        for f in res.findings:
            got.setdefault(f.path, set()).add(f.rule)
        for rel, _src, want in _SEEDS:
            missed = set(want) - got.get(rel, set())
            if missed:
                return _fail(
                    f"seeded violation(s) NOT caught in {rel}: "
                    f"{sorted(missed)} (caught: "
                    f"{sorted(got.get(rel, set()))})")
    n = sum(len(w) for _r, _s, w in _SEEDS)
    print(f"OK: seeded tier — all {n} seeded violations caught")
    return 0


def real_tree(result=None, elapsed=None) -> int:
    """The real tier; ``result``/``elapsed`` reuse a run already made
    (the tests share one whole-tree run between their checks)."""
    from ..analysis import runner
    if result is None:
        t0 = time.perf_counter()
        result = runner.run(_REPO, baseline=os.path.join(
            _REPO, runner.DEFAULT_BASELINE))
        elapsed = time.perf_counter() - t0
    if result.findings:
        lines = "\n  ".join(f.render() for f in result.findings[:20])
        return _fail(f"tree is not lint-clean:\n  {lines}")
    if result.stale_baseline:
        return _fail(f"stale baseline entries: "
                     f"{result.stale_baseline}")
    if elapsed >= 30.0:
        return _fail(f"full-tree lint took {elapsed:.1f}s — past "
                     f"the 30 s CI budget")
    print(f"OK: real tier — tree clean, "
          f"{len(result.baselined)} baselined, "
          f"{len(result.noqa)} noqa-suppressed, "
          f"{elapsed:.1f}s (< 30 s budget)")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    rc = _check_seeded()
    if rc:
        return rc
    if "--quick" not in argv:
        rc = real_tree()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
