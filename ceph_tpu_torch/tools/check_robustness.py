"""Robustness smoke check of the port — a seeded thrash run, invariants
asserted.

The twin of ``scripts/check_robustness.py``.  Drives the failure
pipeline in one pass: a small seeded kill/revive soak
(``cluster/thrasher.py``, its sim on ``--device``; the stack's EC pool
runs the ``jax`` codec, K1 on the card) with the wire-drop and
device-EIO faultpoints armed under client writes, then asserts the
self-healing invariants —

  * every client op completed (OpTracker: zero stuck in flight),
  * zero data loss (readback matches the oracle for every object),
  * deep scrub reports 0 inconsistencies after repair,
  * health converged to HEALTH_OK within the tick bound,
  * every armed faultpoint FIRED at least once (perf-counter proof),
  * the identical seed reproduces the identical schedule and fire
    counts (the regression-test property),

then a quick NETSPLIT soak (seeded partition/heal cycles via
``net.partition`` with ``msg.drop_ack`` losing committed completions)
asserting the same set PLUS replay idempotency (no op applies twice
under session replay) and linear mon epoch history (no split brain).
First of all, the CrashDev smoke (``run_crash_smoke``: host code, the
BlueStore crash-state enumeration).

    python -m ceph_tpu_torch.tools.check_robustness                # the card
    python -m ceph_tpu_torch.tools.check_robustness --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def run_once(seed: int, cycles: int = 3, netsplit: bool = False):
    """One seeded soak of ``build_default_stack`` on the package default
    device; the Thrasher's report."""
    from ..cluster.thrasher import (NETSPLIT_FAULTPOINTS, Thrasher,
                                    ThrashConfig, build_default_stack)
    from ..common import faults
    sim, mon = build_default_stack()
    try:
        cfg = ThrashConfig(seed=seed, cycles=cycles,
                           objects=4, writes_per_cycle=2)
        if netsplit:
            cfg.netsplit = True
            cfg.faultpoints = NETSPLIT_FAULTPOINTS
            cfg.settle_ticks = 40
        t = Thrasher(sim, mon, [1, 2], cfg)
        return t.run()
    finally:
        sim.shutdown()
        faults.reset()


def run_crash_smoke(workdir=None) -> int:
    """CrashDev smoke: a seeded BlueStore workload recorded through the
    BlockDevice shim, a compact crash-state enumeration (every barrier
    cut + seeded torn/lost/reordered images), the acked-write contract
    asserted on each image — and the falsifiability probe: the
    deliberately-broken ordering (KV commit acked before its WAL fsync)
    MUST be caught."""
    import tempfile

    from ..cluster.crashdev import CrashHarness
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="crashdev-smoke-")
    try:
        h = CrashHarness(os.path.join(workdir, "run"), seed=0,
                         n_txns=22)
        h.run_workload()
        rep = h.enumerate_and_check(
            os.path.join(workdir, "imgs"), seeds=(0,),
            images_per_seed=30, barrier_stride=3,
            double_crash_every=6)
        if rep["violations"]:
            print("FAIL: crash-sim contract broken: "
                  + "; ".join(rep["violations"][:5]), file=sys.stderr)
            return 1
        # determinism: the same seed enumerates the same images
        h2 = CrashHarness(os.path.join(workdir, "run2"), seed=0,
                          n_txns=22)
        log2 = h2.run_workload()
        if [r[:3] for r in h.log if r[0] != "write"] != \
                [r[:3] for r in log2 if r[0] != "write"]:
            print("FAIL: same seed produced a different write "
                  "stream", file=sys.stderr)
            return 1
        # falsifiability: broken ordering must FAIL the harness
        # compaction off: a snapshot's fsync+rename would seal the
        # acked state and mask the missing WAL barrier
        hb = CrashHarness(os.path.join(workdir, "broken"), seed=1,
                          n_txns=16, kv_fsync=False,
                          compact_bytes=1 << 20)
        hb.run_workload()
        img, upto = hb.lost_tail_image(os.path.join(workdir, "bimg"))
        if not hb.check_image(img, upto):
            print("FAIL: KV-commit-before-WAL-fsync was NOT caught "
                  "— the crash harness is vacuous", file=sys.stderr)
            return 1
        print(f"crash smoke OK: {rep['barrier_cuts']} barrier cuts + "
              f"{rep['seeded']} seeded images clean, "
              f"{rep['double_crash']} double-crash probes, broken "
              f"ordering caught")
        return 0
    finally:
        if own:
            import shutil
            shutil.rmtree(workdir, ignore_errors=True)


def run_checks() -> int:
    crc = run_crash_smoke()
    if crc:
        return crc
    seed = 5
    r1 = run_once(seed)
    if not r1["ok"]:
        return _fail("invariants broken: " + "; ".join(r1["failures"]))
    inv = r1["invariants"]
    if inv["ops_in_flight"] != 0:
        return _fail(f"{inv['ops_in_flight']} ops stuck in flight")
    if inv["data_loss"]:
        return _fail(f"data loss: {inv['data_loss']}")
    if inv["scrub_inconsistencies"] != 0:
        return _fail(f"scrub found {inv['scrub_inconsistencies']} "
                     f"inconsistencies after repair")
    if inv["health"] != "HEALTH_OK":
        return _fail(f"health ended {inv['health']}")
    for name, n in r1["fire_counts"].items():
        if n < 1:
            return _fail(f"faultpoint {name} never fired")
    if not r1["fire_counts"]:
        return _fail("no faultpoint fired — the soak injected nothing")

    # determinism: the identical seed reproduces the identical
    # schedule and fire counts (what makes a chaos pass a regression
    # test rather than an anecdote)
    r2 = run_once(seed)
    if r1["schedule"] != r2["schedule"]:
        return _fail("same seed produced a different thrash schedule")
    if r1["fire_counts"] != r2["fire_counts"]:
        return _fail(f"same seed produced different fire counts: "
                     f"{r1['fire_counts']} vs {r2['fire_counts']}")

    # netsplit scenario: seeded partition/heal cycles with the full
    # invariant set PLUS replay idempotency (no op applies twice under
    # session replay) and linear mon epoch history
    rn = run_once(seed=7, netsplit=True)
    if not rn["ok"]:
        return _fail("netsplit invariants broken: " +
                     "; ".join(rn["failures"]))
    ninv = rn["invariants"]
    if ninv["replay_double_commits"] != 0:
        return _fail(f"replay applied "
                     f"{ninv['replay_double_commits']} ops twice")
    if not ninv["mon_epochs_linear"]:
        return _fail("mon epoch history forked or gapped")
    if rn["fire_counts"].get("net.partition", 0) < 1:
        return _fail("netsplit soak never severed a frame")

    print(f"OK: {len(r1['schedule'])} scheduled events over "
          f"{r1['cycles']} cycles, fires={r1['fire_counts']}, "
          f"{inv['objects_checked']} objects verified, "
          f"health {inv['health']} in {inv['health_ticks']} ticks, "
          f"schedule reproducible; netsplit: "
          f"{rn['fire_counts']['net.partition']} severed frames, "
          f"{ninv['replay_dups_suppressed']} replays suppressed, "
          f"epochs linear, health {ninv['health']}")
    return 0


def main(argv=None) -> int:
    import ceph_tpu_torch
    ap = argparse.ArgumentParser(
        prog="check_robustness",
        description="the CrashDev smoke, a seeded thrash soak twice and a "
                    "netsplit soak, every invariant held")
    ap.add_argument("--device", default="cuda",
                    help="device of the soaks' sims (default: cuda)")
    args = ap.parse_args(argv)
    with ceph_tpu_torch.using_device(args.device):
        return run_checks()


if __name__ == "__main__":
    sys.exit(main())
