"""The manager's five modules of the port against the reference's:
prometheus, pg_autoscaler, devicehealth, telemetry and dashboard.

Twins of ``tests/test_mgr.py``, ``tests/test_mgr_modules2.py``,
``tests/test_neorados_dashboard.py::test_dashboard_api`` and
``::test_dashboard_pg_perf_crush_config``, and the Prometheus cases of
``tests/test_op_tracker.py``.  Each scenario runs once in each package on
the sim of ``tests/test_snaps``'s size (``tests/torch_twin.make_sim``),
the port on the CPU, and records what the reference test asserts on;
the records must be equal, and so must every object of the sims.

What a module reads from the clock or from process-wide state is made
the same in both runs, as ``tests/torch_twin.py`` does for the gateway:
each run starts from an empty perf registry, a fresh option registry and
zeroed HBM staging gauges (other tests in the process leave options set
and caches staged); the clock that the perf timings read
(``common/perf_counters``, ``op_tracker``, ``osd_service``,
``jit_profile``) stands still, so every timed span is 0 s; and the
modules that stamp reports and samples (telemetry, devicehealth) read
the seeded clock.

One exclusion is named: the reference's registry has a ``jit`` group
(its XLA compiles), which the port has no twin of (ROADMAP C6).  The
reference's ``ceph_tpu_jit_*`` families are left out of its Prometheus
text, and its ``jit`` group out of its ``/api/perf`` body, before they
are compared.  Everything else is compared as the reference prints it,
the ``ceph_tpu_`` family prefix included.
"""
import http.client
import importlib
import json
import time
import types
import urllib.request

import numpy as np
import pytest

import ceph_tpu_torch
from tests import torch_twin
from tests.torch_twin import make_sim

MODULES = ("prometheus_module", "pg_autoscaler", "devicehealth_module",
           "telemetry_module", "dashboard_module")


def pkg(name):
    root = "ceph_tpu" if name == "ref" else "ceph_tpu_torch"

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    ns = types.SimpleNamespace(
        name=name, twin=torch_twin.REF if name == "ref" else torch_twin.PORT,
        mgr=mod("mgr"), pc=mod("common.perf_counters"),
        options=mod("common.options"), store=mod("cluster.device_store"))
    for m in MODULES:
        setattr(ns, m, mod(f"mgr.{m}"))
    ns.timed = [mod(m) for m in ("common.perf_counters",
                                 "common.op_tracker", "cluster.osd_service",
                                 "common.jit_profile")]
    return ns


REF, PORT = pkg("ref"), pkg("port")


def still_clock():
    """A stand-in ``time`` module whose clocks stand still."""
    ns = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                  if not k.startswith("_")})
    ns.perf_counter = lambda: 0.0
    ns.monotonic = lambda: 0.0
    ns.time = lambda: 1_760_000_000.0
    return ns


def run_in(p, scenario, monkeypatch):
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    built = []
    try:
        with monkeypatch.context() as mp:
            mp.setattr(p.pc, "_collection", None)
            # the process-wide state other tests leave behind: options
            # set and not cleared, and the HBM staging gauges' running
            # sums over every cache the process ever staged into
            mp.setattr(p.options, "_config", p.options.Options(
                p.options._TABLE))
            mp.setattr(p.pc, "_enabled", None)
            mp.setattr(p.store, "_hbm_entries", 0)
            mp.setattr(p.store, "_hbm_bytes", 0)
            for m in p.timed:
                mp.setattr(m, "time", still_clock())
            clock = torch_twin.Seeded(0).clock_module()
            for m in ("telemetry_module", "devicehealth_module"):
                mp.setattr(getattr(p, m), "time", clock)

            def host(n_objects=0, seed=2):
                sim = make_sim(p.twin)
                built.append(sim)
                rng = np.random.default_rng(seed)
                for i in range(n_objects):
                    sim.put(1, f"o{i}", rng.integers(
                        0, 256, 5000, dtype=np.uint8).tobytes())
                h = p.mgr.MgrModuleHost(sim)
                for m in MODULES:
                    getattr(p, m).register(h)
                return h

            rec = scenario(p, host)
            state = [torch_twin.sim_state(s) for s in built]
    finally:
        for s in built:
            s.shutdown()
        torch_twin._built[p.twin.name] = []
        ceph_tpu_torch.set_default_device(prev)
    return rec, state


def twin(scenario, monkeypatch):
    """The scenario in both packages; asserts the records and the sims'
    states equal and returns the port's record."""
    ref = run_in(REF, scenario, monkeypatch)
    port = run_in(PORT, scenario, monkeypatch)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    return port[0]


def without_jit(text):
    """The reference's Prometheus text less its ``ceph_tpu_jit_*``
    families (the named exclusion)."""
    return "".join(ln for ln in text.splitlines(keepends=True)
                   if "ceph_tpu_jit_" not in ln)


# ------------------------------------------------------------ lifecycle --

def lifecycle(p, host):
    h = host()
    rec = [h.enabled()]
    h.enable("prometheus")
    h.enable("pg_autoscaler")
    rec.append(h.enabled())
    h.disable("pg_autoscaler")
    rec.append(h.enabled())
    rec.append(torch_twin.outcome(lambda: h.enable("nope")))
    for m in ("dashboard", "telemetry", "devicehealth"):
        h.enable(m)
    rec.append(h.enabled())
    return rec


def test_module_lifecycle(monkeypatch):
    rec = twin(lifecycle, monkeypatch)
    assert rec[1] == ["pg_autoscaler", "prometheus"]
    assert rec[2] == ["prometheus"] and rec[3][:2] == ("raised", "KeyError")


# ----------------------------------------------------------- prometheus --

def prometheus_render(p, host):
    h = host(n_objects=20)
    mod = h.enable("prometheus")
    h.sim.put(2, "ec-obj", b"e" * 3000)
    text = mod.render()
    h.sim.kill_osd(0)
    down = mod.render()
    h.sim.revive_osd(0)
    if p is REF:
        text, down = without_jit(text), without_jit(down)
    return [text, down]


def test_prometheus_render(monkeypatch):
    text, down = twin(prometheus_render, monkeypatch)
    assert "# TYPE ceph_osd_up gauge" in text
    assert 'ceph_osd_up{ceph_daemon="osd.0"} 1' in text
    assert 'ceph_pg_total{pool_id="1"} 16' in text
    assert 'ceph_pool_objects{pool_id="1"} 20' in text
    assert "ceph_health_status 0" in text
    assert 'ceph_osd_up{ceph_daemon="osd.0"} 0' in down
    assert "ceph_health_status 1" in down
    assert "# TYPE ceph_tpu_osd_service_dispatch_s histogram" in text


def test_every_perf_group_renders_as_families(monkeypatch):
    """Each group of the registry that holds a counter after the
    scenario shows up as a family of the render."""
    def scenario(p, host):
        h = host(n_objects=4)
        h.sim.put(2, "ec-obj", b"e" * 3000)
        text = h.enable("prometheus").render()
        return sorted(g for g, d in p.pc.perf().dump_typed().items()
                      if d and g != "jit"), text

    for p in (REF, PORT):
        groups, text = run_in(p, scenario, monkeypatch)[0]
        assert "ec.jax" in groups and "osd.service" in groups
        for g in groups:
            safe = g.replace(".", "_").replace("-", "_")
            assert f"# TYPE ceph_tpu_{safe}_" in text, (p.name, g)


def prometheus_http(p, host):
    h = host(n_objects=5)
    mod = h.enable("prometheus")
    port = mod.start_http(0)
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=30).read().decode()
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=30)
            missing = 200
        except urllib.error.HTTPError as e:
            missing = e.code
    finally:
        mod.stop_http()
    return [without_jit(body) if p is REF else body, missing]


def test_prometheus_http_scrape(monkeypatch):
    body, missing = twin(prometheus_http, monkeypatch)
    assert "ceph_osd_up" in body and missing == 404


def prometheus_histograms(p, host):
    pc = p.pc.perf("t_prom_hist")
    for v in (1e-6, 3e-6, 3e-6, 0.5, 1e12):
        pc.hinc("obs_s", v)
    avg = p.pc.perf("t_prom_avg")
    avg.tinc("lat_s", 0.5)
    avg.tinc("lat_s", 1.5)
    p.pc.perf("t_prom_cnt").inc("ops", 7)
    p.pc.perf("t_prom_cnt").set("depth", 3)
    text = host().enable("prometheus").render()
    lines = []
    p.prometheus_module.PrometheusModule._render_histogram(
        lines, "fam", "h",
        {"count": 3, "sum": 0.25, "buckets": [[1e-6, 1], [4e-6, 2]]})
    esc = [p.prometheus_module._esc(s) for s in
           ('a"b', "a\\b", "a\nb", 'p\\q"r\ns')]
    return [without_jit(text) if p is REF else text, lines, esc]


def test_prometheus_histogram_gauge_and_escaping(monkeypatch):
    text, lines, esc = twin(prometheus_histograms, monkeypatch)
    family = "ceph_tpu_t_prom_hist_obs_s"
    assert f"# TYPE {family} histogram" in text
    assert f'{family}_bucket{{le="+Inf"}} 5' in text
    assert f"{family}_count 5" in text
    assert "# TYPE ceph_tpu_t_prom_avg_lat_s gauge" in text
    assert "ceph_tpu_t_prom_avg_lat_s 1.0" in text
    assert "ceph_tpu_t_prom_cnt_ops 7" in text
    assert 'fam_bucket{le="+Inf"} 3' in lines
    assert esc == ['a\\"b', "a\\\\b", "a\\nb", 'p\\\\q\\"r\\ns']


# -------------------------------------------------------- pg_autoscaler --

def autoscaler(p, host):
    h = host(n_objects=20)
    auto = h.enable("pg_autoscaler")
    rec = [auto.recommendations()]
    pools = h.sim.osdmap.pools
    pools[1].pg_num = pools[1].pgp_num = 4
    rec.append(auto.recommendations())
    auto.serve_tick()                     # warn: nothing applied
    rec.append(pools[1].pg_num)
    pools[1].pg_num = pools[1].pgp_num = 16
    pools[2].pg_num = pools[2].pgp_num = 4
    auto.mode = "on"
    rec.append(auto.recommendations())
    auto.serve_tick()                     # on: the empty pool 2 moves
    rec += [pools[2].pg_num, h.sim.osdmap.epoch, auto.last_recommendations]
    return rec


def test_pg_autoscaler_recommends_and_applies(monkeypatch):
    rec = twin(autoscaler, monkeypatch)
    assert {r["pool_id"] for r in rec[0]} == {1, 2}
    for r in rec[0]:
        assert r["target_pg_num"] >= 4
        assert r["target_pg_num"] & (r["target_pg_num"] - 1) == 0
    assert rec[2] == 4
    rec2 = next(r for r in rec[3] if r["pool_id"] == 2)
    if rec2["would_adjust"]:
        assert rec[4] == rec2["target_pg_num"]


# ------------------------------------------------------------ telemetry --

def telemetry(p, host):
    h = host()
    tel = h.enable("telemetry")
    rec = [torch_twin.outcome(tel.send)]
    for _ in range(10):
        tel.serve_tick()
    rec.append(list(tel.spool))
    tel.on()
    h.sim.put(1, "obj-secret-name", b"z" * 1000)
    rec += [tel.send(), tel.last_report(), json.loads(tel.show())]
    for _ in range(p.telemetry_module.TelemetryModule.INTERVAL_TICKS):
        tel.serve_tick()
    h.sim.kill_osd(2)
    rec += [tel.send(now=5.0), list(tel.spool)]
    tel.off()
    rec.append(torch_twin.outcome(tel.send))
    return rec


def test_telemetry_opt_in_report_and_spool(monkeypatch):
    rec = twin(telemetry, monkeypatch)
    assert rec[0][:2] == ("raised", "RuntimeError") and rec[1] == []
    assert rec[2] == 1
    rep = rec[3]
    assert rep["osd"]["count"] > 0 and rep["total_objects"] >= 1
    assert rep["total_bytes"] >= 1000
    assert "obj-secret-name" not in json.dumps(rep)
    assert rec[4]["pools"]
    assert rec[5] == 3 and [r["report_id"] for r in rec[6]] == [1, 2, 3]
    assert rec[6][2]["health"] == "HEALTH_WARN"


# --------------------------------------------------------- devicehealth --

def devicehealth(p, host):
    h = host()
    dh = h.enable("devicehealth")
    dh.scrape(now=1.0)
    rec = [dh.life_expectancy(0), dh.checks()]
    for t in range(2):
        h.sim.kill_osd(1)
        dh.scrape(now=2.0 + t)
        h.sim.revive_osd(1)
        dh.scrape(now=2.5 + t)
    rec += [dh.life_expectancy(1), dh.checks()]
    dh.record_scrub_errors(2)
    dh.scrape()                              # the seeded clock's stamp
    rec += [dh.life_expectancy(2), dh.checks()]
    for t in range(40):
        dh.scrape(now=10.0 + t)
    rec += [len(dh.metrics[0]), dh.metrics[2][-1], dh.maybe_mark_out()]
    dh.record_scrub_errors(3)
    dh.self_heal = True
    rec += [dh.maybe_mark_out(), int(h.sim.osdmap.osd_weight[3]),
            dh.maybe_mark_out(), dh.checks()]
    dh.serve_tick()
    rec.append({i: list(ring) for i, ring in dh.metrics.items()})
    return rec


def test_devicehealth_verdicts_and_self_heal(monkeypatch):
    rec = twin(devicehealth, monkeypatch)
    assert rec[0] == "good" and rec[1] == {}
    assert rec[2] == "warning" and "DEVICE_HEALTH_WARN" in rec[3]
    assert rec[4] == "failing" and "DEVICE_HEALTH" in rec[5]
    assert rec[6] == REF.devicehealth_module.DeviceHealthModule.HISTORY
    assert rec[8] == []                      # self_heal off
    assert rec[9] == [2, 3] and rec[10] == 0 and rec[11] == []


# ------------------------------------------------------------ dashboard --

ROUTES = ("/api/summary", "/api/pools", "/api/osds", "/api/health",
          "/api/pgs", "/api/perf", "/api/crush", "/api/config", "/",
          "/api/nope")


def dashboard(p, host):
    h = host()
    dash = h.enable("dashboard")
    h.sim.put(1, "obj", b"z" * 500)
    port = dash.start_http()

    def get(path):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("GET", path)
        r = c.getresponse()
        body = r.read()
        c.close()
        if r.getheader("Content-Type") == "application/json":
            body = json.loads(body)
            if path == "/api/perf" and p is REF:
                body.pop("jit", None)          # the named exclusion
        return r.status, body

    try:
        rec = [get(r) for r in ROUTES]
        h.sim.kill_osd(0)
        rec += [get("/api/health"), get("/api/pgs")]
        h.sim.revive_osd(0)
        for o in range(len(h.sim.osds)):
            h.sim.osdmap.mark_down(o)
        rec.append(get("/api/pgs"))
        for o in range(len(h.sim.osds)):
            h.sim.osdmap.osd_up[o] = True
        h.sim.osdmap.bump_epoch()
        rec.append(get("/api/summary"))
    finally:
        dash.stop_http()
    rec.append([dash.api_summary(), dash.api_pools(), dash.api_crush()])
    return rec


def test_dashboard_api(monkeypatch):
    rec = twin(dashboard, monkeypatch)
    got = dict(zip(ROUTES, rec))
    st, s = got["/api/summary"]
    assert st == 200 and s["health"]["status"] == "HEALTH_OK"
    assert "dashboard" in s["mgr_modules"]
    assert any(p["objects"] >= 1 for p in got["/api/pools"][1])
    assert all(o["up"] for o in got["/api/osds"][1])
    pgs = got["/api/pgs"][1]
    assert pgs["states"]["active+clean"] == sum(pgs["states"].values())
    assert got["/api/perf"][1]
    assert any("host" in ln for ln in got["/api/crush"][1]["tree"])
    cfg = got["/api/config"][1]
    assert cfg["erasure_code_default_layout"]["value"] == "bitsliced"
    assert got["/"][0] == 200 and b"dashboard" in got["/"][1]
    assert got["/api/nope"][0] == 404
    health, pgs2, pgs3 = (rec[len(ROUTES) + i][1] for i in range(3))
    assert health["status"] == "HEALTH_WARN" and health["checks"]
    assert pgs2["states"]["active+undersized+degraded"] > 0
    assert any(r["state"] == "active+undersized+degraded" and None in r["up"]
               for rows in pgs2["pgs"].values() for r in rows)
    assert pgs3["states"]["down"] > 0 and pgs3["states"]["active+clean"] == 0


@pytest.mark.parametrize("name", MODULES)
def test_port_module_registers_under_the_references_name(name):
    ref_host = REF.mgr.MgrModuleHost(None)
    port_host = PORT.mgr.MgrModuleHost(None)
    getattr(REF, name).register(ref_host)
    getattr(PORT, name).register(port_host)
    assert sorted(port_host._available) == sorted(ref_host._available)
