"""The port's spans on the placement path and their bridge to the profiler.

The tracer's context-managed spans open a ``record_function`` range of
their name while a ``torch.profiler`` is active, so they stand nested in
the profiler's timeline; a span opened ``on_device`` also measures the
device's time (CUDA timing events, recorded only under a profiler and
read at dump time; on the CPU its own duration).  ``map_pgs_batch``
opens one root a sweep with its stages beneath, and the benchmark's
readers of those spans report the remap cell's three placement metrics on
a tiny CPU run.  Disarmed (``trace_enabled`` false), nothing is made.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ceph_tpu_torch
from ceph_tpu_torch.cluster.osdmap import (Incremental, OSDMap, PGPool,
                                           POOL_REPLICATED)
from ceph_tpu_torch.common import tracer as tracing
from ceph_tpu_torch.common.options import config
from ceph_tpu_torch.placement.builder import TYPE_HOST, build_flat_cluster
from ceph_tpu_torch.placement.crush_map import (RULE_CHOOSELEAF_FIRSTN,
                                                RULE_EMIT, RULE_TAKE, Rule)

torch.set_num_threads(1)

SPAN_METRICS = ("descend_device_ms.remap", "resolve_stream_ms.remap",
                "epoch_host_ms.remap")
FASTMAP_STAGES = ["crush.fastmap.upload", "crush.fastmap.descend",
                  "crush.fastmap.descend", "crush.fastmap.resolve",
                  "crush.fastmap.emit"]


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    tracing.tracer().reset()
    yield
    ceph_tpu_torch.set_default_device(prev)


@pytest.fixture
def counts(monkeypatch):
    """Calls that make a span, a profiler range or a CUDA event."""
    n = {"span": 0, "range": 0, "event": 0}

    def counting(key, real):
        def make(*a, **k):
            n[key] += 1
            return real(*a, **k)
        return make

    monkeypatch.setattr(tracing, "Span", counting("span", tracing.Span))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting("range",
                                 torch.autograd.profiler.record_function))
    monkeypatch.setattr(torch.cuda, "Event",
                        counting("event", torch.cuda.Event))
    return n


@pytest.fixture
def disarmed():
    config().set("trace_enabled", False)
    try:
        yield
    finally:
        config().clear("trace_enabled")
    assert tracing.enabled()


def cpu_events(prof):
    return {e.name: e for e in prof.profiler.function_events}


def make_osdmap(pg_num=2048):
    cmap, root = build_flat_cluster(n_hosts=8, osds_per_host=3)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    om = OSDMap(cmap, device="cpu")
    om.mark_all_in_up()
    om.add_pool(PGPool(id=1, name="rep", type=POOL_REPLICATED, size=3,
                       pg_num=pg_num, crush_rule=0))
    return om


def sweeps(om, n):
    """``n`` epochs, each host 0 out then in, each followed by a sweep."""
    ups = []
    for i in range(n):
        w = 0 if i % 2 == 0 else 0x10000
        om.apply_incremental(Incremental(epoch=om.epoch + 1, new_weight={
            o: w for o in (0, 1, 2)}))
        ups.append(om.map_pgs_batch(1)[0])
    return ups


# ------------------------------------------------------------- the bridge --

def test_a_span_under_the_profiler_is_a_nested_range(counts):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.start_span("outer"):
            with tracing.child_span("inner", on_device="cpu") as s:
                torch.ones(4).sum()
    ev = cpu_events(prof)
    assert ev["outer"].cpu_parent is None
    assert ev["inner"].cpu_parent is ev["outer"]
    assert counts["range"] == 2 and counts["event"] == 0
    # on the CPU the device's time is the span's own
    assert s.device_s() == s.duration > 0


def test_no_profiler_opens_no_range(counts):
    with tracing.start_span("outer"):
        with tracing.child_span("inner", on_device="cpu"):
            pass
    assert counts == {"span": 2, "range": 0, "event": 0}
    dumped = {s["name"]: s for s in tracing.tracer().dump()}
    assert dumped["inner"]["device_s"] == \
        pytest.approx(dumped["inner"]["duration_s"], abs=1e-8)
    assert "device_s" not in dumped["outer"]
    assert dumped["outer"]["t0"] <= dumped["inner"]["t0"]


def test_disarmed_makes_no_span_range_or_event(counts, disarmed):
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.start_span("outer", on_device="cuda"):
            with tracing.child_span("inner", on_device="cuda"):
                pass
    assert counts == {"span": 0, "range": 0, "event": 0}
    assert tracing.tracer().dump() == []


class FakeEvent:
    """A CUDA timing event on the CPU: records its order, 2.5 ms apart."""
    recorded, read = [], []

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self, stream=None):
        self.at = len(FakeEvent.recorded)
        FakeEvent.recorded.append(self)

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        FakeEvent.read.append(self)
        return 2.5 * (other.at - self.at)


def test_cuda_span_times_by_events_read_at_dump(monkeypatch):
    """On a CUDA device a span records one event at entry and one at
    exit, only under a profiler, and reads them at dump, not at exit."""
    FakeEvent.recorded, FakeEvent.read = [], []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: None)
    with tracing.start_span("untraced", on_device="cuda:0"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.start_span("traced", on_device="cuda:0") as s:
            pass
    assert len(FakeEvent.recorded) == 2 and FakeEvent.read == []
    dumped = {d["name"]: d for d in tracing.tracer().dump()}
    assert dumped["traced"]["device_s"] == pytest.approx(2.5e-3)
    assert dumped["untraced"]["device_s"] is None
    assert s.events is None          # read once, then let go
    assert tracing.tracer().dump()[-1]["device_s"] == pytest.approx(2.5e-3)


def test_two_dumps_at_once_read_the_events_once(monkeypatch):
    """Two threads dumping together: one reads the span's events, and
    both give the same ``device_s``."""
    import threading
    import time

    class SlowEvent(FakeEvent):
        def synchronize(self):
            time.sleep(0.05)

    FakeEvent.recorded, FakeEvent.read = [], []
    monkeypatch.setattr(torch.cuda, "Event", SlowEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: None)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.start_span("traced", on_device="cuda:0"):
            pass
    got, start = [], threading.Barrier(2)

    def dump():
        start.wait()
        got.append(tracing.tracer().dump()[0]["device_s"])
    threads = [threading.Thread(target=dump) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == [pytest.approx(2.5e-3)] * 2
    assert len(FakeEvent.read) == 1


def test_an_error_still_closes_the_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(KeyError):
            with tracing.start_span("fails"):
                raise KeyError("x")
        with tracing.start_span("after"):
            pass
    ev = cpu_events(prof)
    assert ev["after"].cpu_parent is None
    spans = {s["name"]: s for s in tracing.tracer().dump()}
    assert spans["fails"]["tags"]["error"] == "KeyError"


# ---------------------------------------------------- the sweep's span tree --

def test_each_sweep_is_one_root_with_its_stages():
    """Two epochs: each is an ``osdmap.apply_incremental`` root and one
    ``osdmap.map_pgs_batch`` root, whose stages lie beneath; 2,048 lanes
    in chunks of 1,024 give two descents (parent, leaf), a resolve and an
    emit a chunk, then one readback."""
    om = make_osdmap()
    config().set("fastmap_max_grid_lanes", 1 << 12)
    try:
        sweeps(om, 2)
    finally:
        config().clear("fastmap_max_grid_lanes")
    trees = tracing.assemble(tracing.tracer().dump())
    roots = [t["roots"][0] for t in trees.values()]
    assert sorted(r["name"] for r in roots) == \
        ["osdmap.apply_incremental"] * 2 + ["osdmap.map_pgs_batch"] * 2
    for root in roots:
        if root["name"] != "osdmap.map_pgs_batch":
            continue
        # lanes the fast mapper leaves incomplete (a host out of 8)
        # are mapped under crush.native_fallback, between the two
        assert [c["name"] for c in root["children"]
                if c["name"] != "crush.native_fallback"] == \
            ["osdmap.pps", "crush.fastmap", "osdmap.post_crush"]
        fast = root["children"][1]
        names = [c["name"] for c in fast["children"]]
        assert names == [FASTMAP_STAGES[0]] + FASTMAP_STAGES[1:] * 2 + \
            ["crush.fastmap.readback"]
        descents = [c for c in fast["children"]
                    if c["name"] == "crush.fastmap.descend"]
        assert [d["tags"]["cands"] for d in descents] == \
            ["parent", "leaf"] * 2
        assert all(d["tags"]["levels"] >= 1 for d in descents)
        assert fast["children"][-1]["tags"]["bytes"] == 2048 * (3 * 8 + 1)
        for c in fast["children"]:
            assert c["device_s"] == pytest.approx(c["duration_s"],
                                                  abs=1e-8)


def test_lanes_that_fall_back_are_spanned(monkeypatch):
    """Lanes the fast mapper leaves incomplete (three forced, besides
    any of its own) are mapped under ``crush.native_fallback``, tagged
    with their count."""
    from ceph_tpu_torch.placement import fast_mapper
    om = make_osdmap(pg_num=64)
    om.map_pgs_batch(1)
    real = fast_mapper.FastMapper.map_batch

    def three_incomplete(self, *a, **k):
        out, inc = real(self, *a, **k)
        inc = inc.copy()
        inc[:3] = True
        return out, inc
    monkeypatch.setattr(fast_mapper.FastMapper, "map_batch",
                        three_incomplete)
    from ceph_tpu_torch.common.perf_counters import perf
    before = perf("crush.mapper").get("fallback_lanes") or 0
    tracing.tracer().reset()
    om.map_pgs_batch(1)
    spans = {s["name"]: s for s in tracing.tracer().dump()}
    lanes = spans["crush.native_fallback"]["tags"]["lanes"]
    assert lanes >= 3
    assert lanes == perf("crush.mapper").get("fallback_lanes") - before
    assert spans["crush.native_fallback"]["parent_id"] == \
        spans["osdmap.map_pgs_batch"]["span_id"]


def test_disarmed_sweep_makes_nothing_and_maps_alike(counts):
    armed = sweeps(make_osdmap(), 2)
    counts.update(span=0, range=0, event=0)
    tracing.tracer().reset()
    config().set("trace_enabled", False)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            bare = sweeps(make_osdmap(), 2)
    finally:
        config().clear("trace_enabled")
    assert counts == {"span": 0, "range": 0, "event": 0}
    assert tracing.tracer().dump() == []
    for a, b in zip(armed, bare):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- the readers --

def test_traced_remap_reports_the_placement_metrics():
    """A tiny CPU traced run of the remap cell: the readers find the
    window's spans and report each metric a sweep."""
    from portbench.tests import tiny
    out = tiny.run("crush_10k_rep3.remap", trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in SPAN_METRICS:
        assert got[name]["unit"] == "ms" and got[name]["value"] > 0, name
    # on the CPU the stages' device time is their host time: the stages
    # do not overlap, so together they fit in the window's epochs
    epoch_ms = 1e3 * out["device"]["window_s"] / out["attempted"]
    assert got["descend_device_ms.remap"]["value"] + \
        got["resolve_stream_ms.remap"]["value"] + \
        got["epoch_host_ms.remap"]["value"] <= epoch_ms
    # an untraced run reads no per-layer metric
    assert not set(got) & set(tiny.run("crush_10k_rep3.remap")["metrics"])


def test_readers_read_nothing_of_a_program_without_the_spans(monkeypatch):
    """Spans without ``t0`` (a program before the bridge) give nothing,
    and the run still reports its other metrics."""
    from portbench.tests import tiny
    real = tracing.Tracer.dump
    monkeypatch.setattr(tracing.Tracer, "dump", lambda self: [
        {k: v for k, v in s.items() if k != "t0"} for s in real(self)])
    out = tiny.run("crush_10k_rep3.remap", trace=True)
    assert out["correct"]
    assert "device_idle_pct.remap" in out["metrics"]
    assert not any(n in out["metrics"] for n in SPAN_METRICS)
