"""Observability smoke check of the port — drives real ops, asserts the
pipeline.

The twin of ``scripts/check_observability.py``.  A few objecter ops flow
through the OSD batch queue and device dispatch of a ClusterSim on
``--device``, and the check asserts every surface they should light up
actually lit up:

  1. ``dump_historic_ops`` is non-empty and each op carries the typed
     lifecycle trail (initiated -> queued -> reached_osd ->
     dispatched_device -> done);
  2. the per-stage latency histograms in the ``op_tracker`` perf group
     have observations;
  3. the Prometheus exporter serves a scrapeable /metrics payload whose
     histogram families are internally consistent (``_bucket``
     cumulative, ``+Inf`` bucket == ``_count``);
  4. the cluster scrape: daemons report over the heartbeat path, the
     mon's ClusterStats merges, one scrape serves per-daemon labeled
     families plus merged cluster histograms and p99 gauges;
  5. slow-op auto-sampling assembles a forced slow op's trace;
  6. disarmed tracing costs one dict miss per site;
  7. the telemetry history turns counter reports into sane rates;
  8. a cold first use of an erasure-code operand inside a traced op
     surfaces as a ``jit.compile`` child span of that op, attributed to
     an ``ec.`` component, and the executing spans carry their ``osd.N``
     service identity (the port compiles no executable per shape; its
     compile spans are the first upload of a coding matrix or mask
     operand to the device and a kernel's first build);
  9. the balancer advisor re-scores a skewed heat fixture strictly
     better and stays a dry run.

The reference's leg 10 (``scripts/bench_compare.py`` over the JAX
package's ``BENCH_r*.json`` snapshots) is not ported: those snapshots
measure the reference, not the port; the leg returns with the port's
own benchmark.

    python -m ceph_tpu_torch.tools.check_observability                # card
    python -m ceph_tpu_torch.tools.check_observability --device cpu
"""
from __future__ import annotations

import argparse
import re
import sys
import urllib.request

SCRAPE_TIMEOUT_S = 10


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def check_metrics_payload(text: str, family: str) -> str:
    """Validate one Prometheus histogram family; '' if OK else why."""
    if f"# TYPE {family} histogram" not in text:
        return f"missing '# TYPE {family} histogram'"
    buckets = [(m.group(1), int(m.group(2))) for m in re.finditer(
        rf'^{re.escape(family)}_bucket{{le="([^"]+)"}} (\d+)$',
        text, re.M)]
    if not buckets:
        return f"{family}: no _bucket samples"
    counts = [n for _, n in buckets]
    if counts != sorted(counts):
        return f"{family}: buckets not cumulative: {counts}"
    if buckets[-1][0] != "+Inf":
        return f"{family}: last bucket is {buckets[-1][0]}, not +Inf"
    m = re.search(rf"^{re.escape(family)}_count (\d+)$", text, re.M)
    if m is None:
        return f"{family}: missing _count"
    if int(m.group(1)) != buckets[-1][1]:
        return (f"{family}: +Inf bucket {buckets[-1][1]} != "
                f"_count {m.group(1)}")
    if int(m.group(1)) == 0:
        return f"{family}: zero observations"
    return ""


def _scrape(port: int) -> str:
    return urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics",
        timeout=SCRAPE_TIMEOUT_S).read().decode()


def cold_operands() -> None:
    """Forget every erasure-code operand already on a device: the coding
    matrices of the byte layout (``gf_jax``) and the mask operands of
    K1 (``xor_kernel``, where the reference forgets its compiled
    shapes), so the next use uploads them again."""
    from ..ops import gf_jax, xor_kernel
    with gf_jax._seen_lock:
        gf_jax._seen_matrices.clear()
    gf_jax._bitmatrix_device.cache_clear()
    with xor_kernel._seen_lock:
        xor_kernel._seen_masks.clear()
    xor_kernel._masks_device.cache_clear()


def run_checks() -> int:
    from ..cluster.monitor import Monitor
    from ..cluster.osdmap import OSDMap, PGPool, POOL_REPLICATED
    from ..cluster.simulator import ClusterSim
    from ..placement.builder import build_flat_cluster
    from ..placement.crush_map import (RULE_CHOOSELEAF_FIRSTN, RULE_EMIT,
                                       RULE_TAKE, Rule)

    cmap, root = build_flat_cluster(n_hosts=4, osds_per_host=2, seed=3)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_FIRSTN, 0, 1),
                              (RULE_EMIT, 0, 0)]))
    om = OSDMap(cmap)
    om.mark_all_in_up()
    om.add_pool(PGPool(id=1, name="rep", type=POOL_REPLICATED, size=3,
                       pg_num=16, crush_rule=0))
    sim = ClusterSim(om)
    try:
        return _legs(sim, Monitor(sim.osdmap))
    finally:
        sim.shutdown()


def _legs(sim, mon) -> int:
    """Legs 1-9 on ``sim`` (a 3-replica pool "rep") and its ``mon``."""
    from ..cluster.objecter import Objecter
    from ..common.op_tracker import tracker
    from ..common.perf_counters import perf
    from ..mgr import MgrModuleHost, prometheus_module
    client = Objecter(sim, mon)

    n_ops = 4
    for i in range(n_ops):
        data = bytes([i]) * 2048
        client.put(1, f"smoke-{i}", data)
        if client.get(1, f"smoke-{i}") != data:
            return _fail(f"smoke-{i}: readback mismatch")

    # 1) historic ring holds the ops, each with the full lifecycle trail
    hist = tracker().dump_historic_ops()
    if hist["num_ops"] < 2 * n_ops:
        return _fail(f"dump_historic_ops: {hist['num_ops']} ops "
                     f"recorded, wanted >= {2 * n_ops}")
    smoke = [op for op in hist["ops"]
             if str(op.get("obj", "")).startswith("smoke-")]
    if len(smoke) < 2 * n_ops:
        return _fail(f"only {len(smoke)} smoke ops in the ring")
    for op in smoke:
        events = [e["event"] for e in op["events"]]
        for want in ("initiated", "queued", "reached_osd",
                     "dispatched_device", "done"):
            if want not in events:
                return _fail(f"op {op['op_id']} ({op['type']} "
                             f"{op['obj']}): missing {want!r} "
                             f"in {events}")

    # 2) per-stage histograms populated
    trk_dump = perf("op_tracker").dump()
    for key in ("stage_init_to_queue_s", "stage_osd_to_device_s"):
        if trk_dump.get(key, {}).get("count", 0) == 0:
            return _fail(f"op_tracker.{key}: no observations")

    # 3) /metrics scrapes and the histogram families are well-formed
    host = MgrModuleHost(sim)
    prometheus_module.register(host)
    mod = host.enable("prometheus")
    port = mod.start_http(0)
    try:
        text = _scrape(port)
    finally:
        mod.stop_http()
    for family in ("ceph_tpu_objecter_op_e2e_s",
                   "ceph_tpu_osd_service_dispatch_s"):
        why = check_metrics_payload(text, family)
        if why:
            return _fail(why)

    # ---- ClusterTelemetry: the cluster-level plane ----
    import time

    from ..cluster.heartbeat import HeartbeatMonitor
    from ..common import tracer as tracing
    from ..common.options import config

    # 4) cluster Prometheus scrape: daemons report over the heartbeat
    # path, the mon's ClusterStats merges, and ONE scrape serves
    # per-daemon labeled families plus merged cluster histograms
    hb = HeartbeatMonitor(sim, mon)
    hb.tick()
    hb.tick()
    chost = MgrModuleHost(sim, mon)
    prometheus_module.register(chost)
    cmod = chost.enable("prometheus")
    cport = cmod.start_http(0)
    try:
        ctext = _scrape(cport)
    finally:
        cmod.stop_http()
    if 'ceph_daemon="osd.0"' not in ctext:
        return _fail("cluster scrape: no per-daemon labels")
    fams = [ln.split()[2] for ln in ctext.splitlines()
            if ln.startswith("# TYPE ")]
    dup = sorted({f for f in fams if fams.count(f) > 1})
    if dup:
        return _fail(f"cluster scrape: duplicate # TYPE families "
                     f"{dup} (a Prometheus parser rejects the whole "
                     f"scrape)")
    if "# TYPE ceph_cluster_op_tracker_op_e2e_s" not in ctext and \
            "# TYPE ceph_cluster_objecter_op_e2e_s" not in ctext:
        return _fail("cluster scrape: no merged cluster histogram "
                     "families")
    if 'quantile="0.99"' not in ctext:
        return _fail("cluster scrape: no merged p99 quantile gauges")
    # merged quantiles must agree with the per-daemon sources
    cs = mon.cluster_stats
    qq = cs.merged_quantiles()
    fam = qq.get("objecter.op_e2e_s")
    if not fam or fam["count"] == 0 or fam["p99"] is None:
        return _fail(f"cluster stats: empty merged op_e2e_s ({fam})")
    src = perf("objecter").dump()["op_e2e_s"]
    if fam["count"] != src["count"]:
        return _fail(f"merged count {fam['count']} != source "
                     f"{src['count']}")

    # 5) slow-op auto-sampling: force one slow op, assert its trace
    # assembles end-to-end (>= 5 linked stages), retrievable by op id
    config().set("op_tracker_complaint_time", 0.01)
    for svc in sim.services:
        svc.inject_execute_delay = 0.02
    try:
        client.put(1, "slowpoke", b"s" * 2048)
    finally:
        for svc in sim.services:
            svc.inject_execute_delay = 0.0
        config().clear("op_tracker_complaint_time")
    slow = tracker().dump_historic_slow_ops()
    rec = next((op for op in slow["ops"]
                if op.get("obj") == "slowpoke"), None)
    if rec is None or not rec.get("trace_id"):
        return _fail("slow op missing from the slow ring or carries "
                     "no trace_id")
    trees = tracing.assemble(
        tracing.tracer().spans_for(rec["trace_id"]))
    tree = trees.get(rec["trace_id"])
    if tree is None or tree["spans"] < 5:
        return _fail(f"auto-sampled slow trace too thin: {tree}")
    if rec["trace_id"] not in tracing.tracer().sampled_traces():
        return _fail("slow trace was not pinned (auto-sampling)")

    # 6) disarmed tracing is one dict-miss (the faultpoint contract)
    tracing.disarm()
    try:
        t0 = time.perf_counter()
        for _ in range(100_000):
            tracing.stamp({"cmd": "put_shard"})
            with tracing.child_span("x"):
                pass
        dt = time.perf_counter() - t0
    finally:
        tracing.arm()
    if dt > 1.0:
        return _fail(f"disarmed trace sites cost {dt:.2f}s per 100k "
                     f"(want << 1s)")

    # ---- ClusterScope: history, heat, compile spans ----
    import math

    # 7) telemetry history range query: writes between two heartbeat
    # deliveries become a per-daemon counter series whose derived
    # rates are finite, non-negative, and somewhere positive
    for i in range(6):
        client.put(1, f"hist-{i}", b"h" * 4096)
    time.sleep(0.02)             # distinct report timestamps
    hb.tick()
    hq = cs.history.query("osd.io.wr_ops")
    if not hq.get("series"):
        return _fail("telemetry history: query returned no series")
    n_samples = 0
    any_pos = False
    for daemon, ser in hq["series"].items():
        if len(ser["samples"]) < 2:
            continue
        n_samples = max(n_samples, len(ser["samples"]))
        vals = [v for _, v in ser["samples"]]
        if ser.get("resets", 0) == 0 and vals != sorted(vals):
            return _fail(f"history[{daemon}]: non-monotonic counter "
                         f"series without a counted reset: {vals}")
        for _ts, r in ser["rates"]:
            if not (r >= 0.0) or math.isinf(r) or math.isnan(r):
                return _fail(f"history[{daemon}]: insane rate {r}")
            any_pos = any_pos or r > 0.0
    if n_samples < 2:
        return _fail("telemetry history: no daemon retained >= 2 "
                     "samples")
    if not any_pos:
        return _fail("telemetry history: writes landed but every "
                     "derived rate is zero")

    # 8) a forced cold first use inside a traced op must surface as a
    # `jit.compile` child span in that op's assembled trace — and the
    # executing-daemon spans must carry their OWN service identity
    import copy

    from ..cluster.osdmap import PGPool, POOL_ERASURE
    sim.create_ec_profile("obsec", {"plugin": "jax", "k": "2",
                                    "m": "1"})
    sim.osdmap.add_pool(PGPool(id=2, name="ecobs", type=POOL_ERASURE,
                               size=3, pg_num=8, crush_rule=0,
                               erasure_code_profile="obsec"))
    client.osdmap = copy.deepcopy(sim.osdmap)   # resync client view
    cold_operands()
    config().set("op_tracker_complaint_time", 0.0001)
    try:
        client.put(2, "coldpoke", b"c" * 8192)
    finally:
        config().clear("op_tracker_complaint_time")
    slow = tracker().dump_historic_slow_ops()
    crec = next((op for op in slow["ops"]
                 if op.get("obj") == "coldpoke"), None)
    if crec is None or not crec.get("trace_id"):
        return _fail("cold-compile op missing from the slow ring or "
                     "carries no trace_id")
    cspans = tracing.tracer().spans_for(crec["trace_id"])
    jit_spans = [s for s in cspans if s["name"] == "jit.compile"]
    if not jit_spans:
        return _fail(f"cold-compile trace has no jit.compile span "
                     f"({sorted({s['name'] for s in cspans})})")
    comps = {s.get("tags", {}).get("component") for s in jit_spans}
    if not any(str(c).startswith("ec.") for c in comps):
        return _fail(f"jit.compile span not attributed to an EC "
                     f"component: {sorted(map(str, comps))}")
    osd_svcs = {s.get("service") for s in cspans
                if s["name"] in ("osd.dispatch", "device.dispatch")}
    if not any(str(s).startswith("osd.") for s in osd_svcs):
        return _fail(f"executor spans carry no osd.N service "
                     f"identity: {sorted(map(str, osd_svcs))}")

    # 9) balancer advisor: on a skewed heat fixture the proposed
    # mapping must re-score strictly better — and stay a DRY RUN
    from ..mgr import balancer_advisor
    for _ in range(40):
        client.put(1, "hotspot", b"H" * 8192)
    time.sleep(0.01)
    hb.tick()
    heat_rows = cs.pg_heat(top=5)
    if not heat_rows or heat_rows[0]["heat"] <= 0:
        return _fail(f"pg heat: no hot rows after skewed traffic "
                     f"({heat_rows})")
    if heat_rows[0]["tot_wr_ops"] < 40:
        return _fail(f"pg heat: hottest row only "
                     f"{heat_rows[0]['tot_wr_ops']} writes — the "
                     f"hotspot PG is not on top")
    epoch0 = sim.osdmap.epoch
    upmaps0 = (dict(sim.osdmap.pg_upmap),
               dict(sim.osdmap.pg_upmap_items))
    rep = balancer_advisor.evaluate(sim.osdmap, cs, max_moves=8)
    if sim.osdmap.epoch != epoch0 or \
            (dict(sim.osdmap.pg_upmap),
             dict(sim.osdmap.pg_upmap_items)) != upmaps0:
        return _fail("balancer advisor ACTUATED (osdmap changed on a "
                     "dry run)")
    if rep["score_before"] <= 0:
        return _fail(f"advisor: zero imbalance on a skewed fixture "
                     f"({rep})")
    if not rep["proposals"]:
        return _fail(f"advisor proposed no moves on a skewed fixture "
                     f"(score {rep['score_before']})")
    if not rep["score_after"] < rep["score_before"]:
        return _fail(f"advisor score did not improve: "
                     f"{rep['score_before']} -> {rep['score_after']}")

    print(f"OK: {len(smoke)} tracked ops, per-stage histograms live, "
          f"/metrics scrapeable ({len(text)} bytes), cluster scrape "
          f"{len(ctext)} bytes ({len(cs.daemons())} daemons), slow "
          f"trace {tree['spans']} spans, disarmed 100k in {dt:.3f}s, "
          f"history {n_samples} samples, {len(jit_spans)} jit.compile "
          f"span(s), advisor {rep['score_before']} -> "
          f"{rep['score_after']} in {rep['moves']} moves")
    return 0


def main(argv=None) -> int:
    import ceph_tpu_torch
    ap = argparse.ArgumentParser(
        prog="check_observability",
        description="the op trail, histograms, scrapes, traces, history, "
                    "compile spans and the balancer advisor of one sim")
    ap.add_argument("--device", default="cuda",
                    help="device of the sim (default: cuda)")
    args = ap.parse_args(argv)
    with ceph_tpu_torch.using_device(args.device):
        return run_checks()


if __name__ == "__main__":
    sys.exit(main())
