"""The port's DR drill against ceph_tpu's.

``cluster/dr_drill.py``: two zones (sim clusters, the port's on the
CPU), a seeded S3 workload on zone A while zone B syncs, a
``net.partition`` sever, failover of the writes to B, heal, and the hard
convergence gate.  On the same seed both packages must give the same
report, but for its wall-clock field (the replication-lag p99): the same
schedule digest, oracle size, verdicts, failures, events and sync-agent
counts.  The falsifiability leg (one lost bilog entry) must turn both
red on the same key.  Each test names its reference twin in
tests/test_dr_drill.py; the live-zone chaos twin is marked ``slow`` as
its reference is.
"""
import io
import time

import pytest
import torch

import ceph_tpu_torch
from tests.torch_twin import PORT, REF, seeded

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

WALL_CLOCK = ("lag_p99_s",)


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)
    PORT.faults.reset()
    REF.faults.reset()


def drill(pkg, monkeypatch, **cfg):
    """One drill in ``pkg`` with seeded tokens and a seeded clock that
    starts at the wall clock's time (the sync agents take the lag of an
    entry against the wall clock); the report without its wall-clock
    fields."""
    with monkeypatch.context() as mp:
        seeded(mp, pkg, t0=time.time())
        r = pkg.drill.run_drill(pkg.drill.DrillConfig(**cfg))
    return {k: v for k, v in r.items() if k not in WALL_CLOCK}, r


@pytest.mark.parametrize("seed", [0, 1])
def test_dr_drill_green(seed, monkeypatch):
    """::test_dr_drill_green"""
    port, r = drill(PORT, monkeypatch, seed=seed)
    assert port == drill(REF, monkeypatch, seed=seed)[0]
    assert r["ok"], r["failures"]
    assert r["converged"] and r["sever_verified"] and r["resharded"]
    assert r["lag_samples"] > 0 and r["lag_p99_s"] is not None
    assert r["lag_p99_s"] <= PORT.drill.DrillConfig().lag_bound_s
    agents = r["agents"].values()
    assert sum(a["double_applies"] for a in agents) == 0
    assert sum(a["full_syncs"] for a in agents) == 0
    assert sum(a["gen_cutovers"] for a in agents) >= 1


def test_dr_drill_schedule_deterministic(monkeypatch):
    """::test_dr_drill_schedule_deterministic and ::test_check_dr_smoke
    (scripts/check_dr.py's determinism leg, seed 2)"""
    cfg = dict(seed=5, phase_ops=12, keys=8, reshard_to=0)
    a = PORT.drill.run_drill(PORT.drill.DrillConfig(**cfg))
    b = PORT.drill.run_drill(PORT.drill.DrillConfig(**cfg))
    ref = REF.drill.run_drill(REF.drill.DrillConfig(**cfg))
    assert a["schedule_digest"] == b["schedule_digest"] == \
        ref["schedule_digest"]
    assert a["ok"] and b["ok"]
    c = PORT.drill.run_drill(PORT.drill.DrillConfig(
        seed=6, phase_ops=12, keys=8, reshard_to=0))
    assert c["schedule_digest"] != a["schedule_digest"]
    two = dict(seed=2, phase_ops=12, keys=8, reshard_to=0)
    assert drill(PORT, monkeypatch, **two)[0] == \
        drill(REF, monkeypatch, **two)[0]


def test_dr_drill_falsifiable_on_lost_bilog(monkeypatch):
    """::test_dr_drill_falsifiable_on_lost_bilog, through the CLI entry
    (``drill_main --lose-bilog --device cpu``); its report equals the
    reference's."""
    buf = io.StringIO()
    with monkeypatch.context() as mp:
        seeded(mp, PORT, t0=time.time())
        rc = PORT.drill.drill_main(["--seed", "0", "--lose-bilog",
                                    "--device", "cpu"], out=buf)
    assert rc != 0
    assert "lost-canary" in buf.getvalue()
    port, r = drill(PORT, monkeypatch, seed=0, lose_bilog=True)
    assert port == drill(REF, monkeypatch, seed=0, lose_bilog=True)[0]
    assert not r["ok"] and any("lost-canary" in f for f in r["failures"])


def test_serve_main_routes_dr_to_the_drill(monkeypatch):
    """``python -m ceph_tpu_torch.rgw.serving --dr`` runs the drill (the
    reference's ``ceph serve --dr``)."""
    buf = io.StringIO()
    with monkeypatch.context() as mp:
        seeded(mp, PORT, t0=time.time())
        rc = PORT.serving.serve_main(["--dr", "--seed", "1", "--phase-ops",
                                      "12", "--keys", "8", "--reshard-to",
                                      "0", "--device", "cpu"], out=buf)
    assert rc == 0 and buf.getvalue().startswith("dr drill seed=1 keys=")


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1])
def test_dr_drill_chaos_live_zone(seed):
    """::test_dr_drill_chaos_live_zone: zone A on the port's live OSD
    daemons eats a kill9 and a powercycle during catch-up."""
    r = PORT.drill.run_drill(PORT.drill.DrillConfig(seed=seed, chaos=True))
    assert r["ok"], r["failures"]
    assert len(r["chaos"]) == 2, r["chaos"]
    assert {k for k, _ in r["chaos"]} == {"kill", "powercycle"}
    assert sum(a["double_applies"] for a in r["agents"].values()) == 0
