"""GeoSync DR smoke check of the port — multisite replication, verified.

The twin of ``scripts/check_dr.py``.  Three assertions, small enough for
the smoke sweep, each on two sim zones of ``--device``:

  1. DRILL GREEN: the two-zone DR drill (sever -> failover -> heal,
     with a mid-catch-up reshard) converges — every acked ETag readable
     in BOTH zones, zero double-applies, zero full-sync restarts, a
     generation cutover recorded, and the replication-lag p99 was
     actually read from the merged histograms (samples > 0).

  2. FALSIFIABILITY: the seeded lost-bilog-entry fault
     (``rgw.bilog_lost_entry`` dropping ONE acked write's log append)
     turns the SAME drill red with a nonzero exit — a convergence gate
     that cannot fail proves nothing.

  3. DETERMINISM: two drills on the same seed produce an identical
     workload schedule digest (the replayable-drill contract).

The drill's zones hold replicated pools only, so it launches no K1.  On
the card, ``chip_smoke.py`` runs the determinism leg here (``--quick``);
the green and red drills run at full size in its phase 13d.

    python -m ceph_tpu_torch.tools.check_dr                # the card
    python -m ceph_tpu_torch.tools.check_dr --device cpu
    python -m ceph_tpu_torch.tools.check_dr --quick        # determinism
"""
from __future__ import annotations

import argparse
import io
import sys


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def _check_drill_green() -> int:
    from ..cluster.dr_drill import DrillConfig, run_drill
    r = run_drill(DrillConfig(seed=0))
    if not r["ok"]:
        return _fail(f"DR drill seed 0 failed the convergence gate: "
                     f"{r['failures']}")
    if not r["sever_verified"]:
        return _fail("the net.partition sever never blocked a pump")
    if not r["lag_samples"]:
        return _fail("no replication-lag samples — the lag bound was "
                     "never read from the histogram merge")
    cuts = sum(a["gen_cutovers"] for a in r["agents"].values())
    if r["resharded"] and not cuts:
        return _fail("mid-catch-up reshard never cut a generation "
                     "over")
    print(f"drill green: {r['keys']} oracle keys converged in both "
          f"zones, lag p99 {r['lag_p99_s']}s over "
          f"{r['lag_samples']} samples, {cuts} gen cutover(s)")
    return 0


def _check_drill_falsifiable() -> int:
    from ..cluster.dr_drill import drill_main
    buf = io.StringIO()
    rc = drill_main(["--seed", "0", "--lose-bilog"], out=buf)
    text = buf.getvalue()
    if rc == 0:
        return _fail("lost-bilog drill PASSED the gate — the "
                     "convergence gate is not falsifiable")
    if "lost-canary" not in text:
        return _fail(f"lost-bilog drill failed without naming the "
                     f"lost key:\n{text}")
    print("falsifiability ok: seeded lost-bilog-entry fault exits "
          "nonzero naming the unreplicated key")
    return 0


def _check_determinism() -> int:
    from ..cluster.dr_drill import DrillConfig, run_drill
    a = run_drill(DrillConfig(seed=2, phase_ops=12, keys=8,
                              reshard_to=0))
    b = run_drill(DrillConfig(seed=2, phase_ops=12, keys=8,
                              reshard_to=0))
    if a["schedule_digest"] != b["schedule_digest"]:
        return _fail(f"same-seed drills diverged: "
                     f"{a['schedule_digest'][:12]} != "
                     f"{b['schedule_digest'][:12]}")
    print(f"determinism ok: seed-2 schedule digest "
          f"{a['schedule_digest'][:12]} reproduced")
    return 0


def main(argv=None) -> int:
    import ceph_tpu_torch
    from ..common import faults
    ap = argparse.ArgumentParser(
        prog="check_dr",
        description="the two-zone DR drill: determinism, green, and red "
                    "with one lost bilog entry")
    ap.add_argument("--device", default="cuda",
                    help="device of the zones' sims (default: cuda)")
    ap.add_argument("--quick", action="store_true",
                    help="the determinism leg only")
    args = ap.parse_args(argv)
    with ceph_tpu_torch.using_device(args.device):
        try:
            rc = _check_determinism()
            if rc:
                return rc
            if not args.quick:
                rc = _check_drill_green() or _check_drill_falsifiable()
                if rc:
                    return rc
        finally:
            faults.reset()
    print("check_dr: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
