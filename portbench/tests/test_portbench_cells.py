"""Whole runs of the cells on the CPU at small sizes through the test
hook (``harness.run_cell``): sound runs come out correct; a control and
each fault the cell can have come out not correct; a configuration, a
mix and a metric are taken from files alone."""
import json
import shutil

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from portbench.tests import tiny

CELLS = list(tiny.CELLS)


@pytest.fixture(autouse=True)
def cpu():
    ceph_tpu_torch.set_default_device("cpu")


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = tiny.run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in tiny.bench()["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_its_layers(workload):
    out = tiny.run(workload, trace=True)
    assert out["correct"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in tiny.bench()["per_layer"]
             if workload in m["workloads"]}
    # the device's numbers need a card; the host's are all there
    assert {n for n in names if "roofline" not in n
            and "idle" not in n} <= set(out["metrics"])


def test_traced_run_keeps_every_span():
    """A traced run's spans all stay in the program's buffer, however
    small its own bound, so the span readers sum the whole window; the
    bound is restored afterwards."""
    from ceph_tpu_torch.common.tracer import tracer
    buf = tracer()
    bound, buf.max_spans = buf.max_spans, 20
    try:
        dropped = buf.spans_dropped
        out = tiny.run("crush_10k_rep3.remap", trace=True)
        assert buf.spans_dropped == dropped
        assert len(buf.dump()) > 20 and buf.max_spans == 20
        assert "descend_device_ms.remap" in out["metrics"]
    finally:
        buf.max_spans = bound


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    out = tiny.control(workload)
    assert not out["correct"], out["checks"]


def flip_k1(monkeypatch):
    """An answer altered where it is produced: one bit of every K1
    result."""
    from ceph_tpu_torch.ops import xor_kernel
    real = xor_kernel.xor_matmul_w32

    def flipped(masks, words):
        out = real(masks, words).clone()
        out.view(-1)[0] ^= 1
        return out
    monkeypatch.setattr(xor_kernel, "xor_matmul_w32", flipped)


class Previous:
    """Returns what the call before returned (state left unchanged), or
    half of it from the call before (half the batch left out)."""

    def __init__(self, fn, half=False):
        self.fn, self.half, self.prev = fn, half, None

    def __call__(self, *a):
        out = self.fn(*a)
        prev, self.prev = self.prev, out
        if prev is None:
            return out
        if not self.half:
            return prev
        if isinstance(out, bytes):
            return out[:len(out) // 2] + bytes(len(out) - len(out) // 2)
        mixed = np.array(out)
        mixed[len(mixed) // 2:] = prev[len(prev) // 2:]
        return mixed


def ingest_fault(kind):
    def hooks(loop):
        if kind == "unchanged":
            return {"put_all": lambda names, datas: None}
        return {"put_all": lambda names, datas: loop.put_all(names[::2],
                                                             datas[::2])}
    return hooks


def read_fault(kind):
    return lambda loop: {"get": Previous(loop.sys.client.get,
                                         half=kind == "half")}


def remap_fault(kind):
    def hooks(loop):
        sweep = loop.sys.osdmap.map_pgs_batch
        if kind == "altered":
            def fn(pool_id):
                up = np.array(sweep(pool_id)[0])
                up[0, 0] = (up[0, 0] + 1) % 200
                return up
        else:
            fn = Previous(lambda pool_id: sweep(pool_id)[0],
                          half=kind == "half")
        return {"map_pgs_batch": lambda pool_id, pss=None: (fn(pool_id),)}
    return hooks


FAULTS = [(w, f) for w in CELLS for f in ("unchanged", "half", "altered")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    hooks = None
    if fault == "altered" and workload.startswith("rbd"):
        flip_k1(monkeypatch)
    elif workload.endswith("ingest"):
        hooks = ingest_fault(fault)
    elif workload.endswith("degraded_read"):
        hooks = read_fault(fault)
    else:
        hooks = remap_fault(fault)
    out = tiny.run(workload, seconds=1.0, hooks=hooks)
    assert not out["correct"], out["checks"]


class StaleSweeps:
    """A sweep that returns at once: the all-in answer, mapped once and
    then served for every epoch, so each sweep with a host out is stale
    in the lanes whose up set held that host."""

    def __init__(self):
        self.loop = self.answer = None

    def __call__(self, loop):
        real = loop.sys.osdmap.map_pgs_batch
        self.loop = loop

        def sweep(pool_id, pss=None):
            if self.answer is None:
                self.answer = real(pool_id, pss)
            return self.answer
        return {"map_pgs_batch": sweep}


def test_check_after_many_fast_sweeps_is_bounded(monkeypatch):
    """However many sweeps the window holds, the check's reference maps
    at most 4 x pg_num lanes, and still finds every stale lane."""
    from portbench.reference import straw2
    cell = "crush_10k_rep3.remap"
    sound = tiny.run(cell)
    mapped = []
    real = straw2.map_firstn

    def counted(x, *a, **kw):
        mapped.append(len(x))
        return real(x, *a, **kw)
    monkeypatch.setattr(straw2, "map_firstn", counted)
    stale = StaleSweeps()
    out = tiny.run(cell, hooks=stale)
    cfg, _ = tiny.CELLS[cell]
    assert out["attempted"] >= 50 * sound["attempted"]
    held = stale.answer[0].astype(np.int64) // cfg["osds_per_host"]
    affected = sum(int((held == h).any(1).sum())
                   for h, _ in stale.loop.sweeps if h is not None)
    assert not out["correct"]
    assert out["checks"]["wrong_lanes"]["value"] == affected > 0
    assert mapped[0] == cfg["pg_num"]
    assert sum(mapped) <= 4 * cfg["pg_num"]


NEW_LOOP = '''"""Reads of objects drawn from the seed, after set-up wrote them."""
from portbench.generator import ECLoop, payloads


class Loop(ECLoop):

    def setup(self):
        self.setup_image()
        self.datas = payloads(len(self.names), self.cfg["object_bytes"],
                              self.seed, self.device)
        self.prefill(self.datas, self.t["batch_objects"])
        self.got = []
        self.work = {"objects": 0}

    def step(self):
        i = int(self.rng.integers(len(self.names)))
        get = self.hooks.get("get", self.sys.client.get)
        self.got.append((i, self.timed("get", lambda: get(
            self.sys.pool_id, self.names[i]))))
        self.work["objects"] += 1

    def check(self):
        wrong = sum(d != self.datas[i] for i, d in self.got)
        return {"wrong_reads": (wrong, 0), "failed_ops": (self.failed, 0)}
'''

NEW_SYSTEM = '''"""The benchmark's EC pool under a name of its own."""
from portbench.harness import load
from portbench.tests.conftest import ROOT


def build(cfg, device):
    return load(ROOT / "portbench/systems/ec_pool.py").build(cfg, device)
'''


def test_a_new_cell_is_taken_from_files(tmp_path):
    """A configuration, a system, a mix of a new kind, its loop and a
    metric that the repository does not have, each a file in a directory
    of its own, run as data."""
    pb = tmp_path / "pb"
    for sub in ("configs", "systems", "traffic", "loops", "metrics"):
        (pb / sub).mkdir(parents=True)
    cfg = json.loads((tiny.ROOT / "portbench/configs/rbd_ec_k8m3.json")
                     .read_text())
    cfg.update(name="tiny_ec_k4m2", system="tiny_pool", k=4, m=2, hosts=8,
               osds_per_host=1, pg_num=8, object_bytes=32768,
               image_objects=6)
    (pb / "configs/tiny_ec_k4m2.json").write_text(json.dumps(cfg))
    (pb / "systems/tiny_pool.py").write_text(NEW_SYSTEM)
    (pb / "loops/random_gets.py").write_text(NEW_LOOP)
    (pb / "traffic/gets.json").write_text(json.dumps(
        {"kind": "random_gets", "batch_objects": 3}))
    (pb / "metrics/objects_per_s.py").write_text(
        "def read(run):\n"
        "    return run['work']['objects'] / run['window_s']\n")
    shutil.copy(tiny.ROOT / "portbench/metrics/setup_s.py",
                pb / "metrics/setup_s.py")
    bench = {"paths": ["pb"],
             "configs": [{"name": "tiny_ec_k4m2",
                          "file": "pb/configs/tiny_ec_k4m2.json"}],
             "workloads": [{"name": "tiny_ec_k4m2.gets",
                            "config": "tiny_ec_k4m2", "traffic": "gets",
                            "chips": 1}],
             "end_to_end": [{"name": "objects_per_s", "unit": "objects/s"},
                            {"name": "setup_s", "unit": "s"}],
             "per_layer": []}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    from portbench import harness
    out = harness.run_cell(tmp_path, bench, "tiny_ec_k4m2.gets", 5, 0.5,
                           False, "cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"objects_per_s", "setup_s"}
    assert out["metrics"]["objects_per_s"]["value"] > 0
    # the new loop's answers are judged: one altered read is not correct
    def reversed_reads(loop):
        get = loop.sys.client.get
        return {"get": lambda pool_id, name: get(pool_id, name)[::-1]}
    out = harness.run_cell(tmp_path, bench, "tiny_ec_k4m2.gets", 5, 0.5,
                           False, "cpu", hooks=reversed_reads)
    assert not out["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_small_cells_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from portbench import harness
    cfg, mix = tiny.CELLS[workload]
    out = harness.run_cell(tiny.ROOT, tiny.bench(), workload, 3, 1.0,
                           True, "cuda", config_override=cfg,
                           traffic_override=mix)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_every_piece_of_a_cell_is_a_file(workload):
    """The manifest's cells and the parked ones name a configuration, a
    system, a mix, a loop and metrics that are files, and no parked cell
    is also in the manifest."""
    from portbench import harness
    bench = tiny.bench()
    manifest = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    conf = json.loads((tiny.ROOT / cfg["file"]).read_text())
    harness.find(tiny.ROOT, bench, "systems", conf["system"] + ".py")
    mix = harness.load_json(harness.find(tiny.ROOT, bench, "traffic",
                                         cell["traffic"] + ".json"))
    harness.find(tiny.ROOT, bench, "loops", mix["kind"] + ".py")
    for trace_on in (False, True):
        for m in harness.cell_metrics(bench, workload, trace_on):
            harness.find(tiny.ROOT, bench, "metrics", m["name"] + ".py")
    in_manifest = workload in {w["name"] for w in manifest["workloads"]}
    parked = json.loads((tiny.ROOT / "portbench/parked.json").read_text())
    assert in_manifest != (workload in {w["name"]
                                        for w in parked["workloads"]})
