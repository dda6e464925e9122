"""The port's offline tools against the reference's: crushtool, osdmaptool
(``--test-map-pgs`` and ``--upmap``) and bench_sweep, each run in both
packages on the same inputs with the port asked for the CPU, and every
CLI that does device work defaulting to the card.

Twins of ``tests/test_tools.py:24-77``; every comparison is exact (the
stdout text, the JSON written, the rows).  Timings go to stderr in both
packages and are not compared.
"""
import contextlib
import io
import json
from pathlib import Path

import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.placement.crush_map import (
    RULE_CHOOSELEAF_FIRSTN, RULE_EMIT, RULE_TAKE, Rule)
from ceph_tpu.tools import bench_sweep as ref_bench_sweep
from ceph_tpu.tools import crushtool as ref_crushtool
from ceph_tpu.tools import osdmaptool as ref_osdmaptool
from ceph_tpu_torch.tools import (bench_sweep, cephadm, crushtool,
                                  osdmaptool, rados_cli)
from tests.test_xla_mapper import TYPE_HOST, build_cluster

CLUSTER_JSON = Path(__file__).parent / "cli" / "cluster.json"


def run(main, argv):
    """(rc, stdout, stderr) of ``main(argv)`` in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def both(ref_main, port_main, argv):
    """The reference's and the port's (rc, stdout, stderr); the port
    gets ``--device cpu``."""
    return (run(ref_main, argv),
            run(port_main, list(argv) + ["--device", "cpu"]))


@pytest.fixture(scope="module")
def map_spec(tmp_path_factory):
    cmap, root = build_cluster(n_hosts=4, osds_per_host=3)
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0),
                              (RULE_CHOOSELEAF_FIRSTN, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)], name="replicated_rule"))
    p = tmp_path_factory.mktemp("maps") / "map.json"
    p.write_text(json.dumps(cmap.to_spec()))
    return str(p), cmap


def test_crushtool_test_mode(map_spec):
    path, _ = map_spec
    ref, port = both(ref_crushtool.main, crushtool.main,
                     ["--infn", path, "--test", "--min-x", "0",
                      "--max-x", "63", "--num-rep", "3",
                      "--show-utilization", "--show-statistics",
                      "--show-bad-mappings"])
    assert port[0] == ref[0] == 0
    assert port[1] == ref[1]
    assert "num_osds_mapped 12" in port[1]
    assert "size 3:\t64/64" in port[1]


def test_crushtool_scalar_matches_batched(map_spec):
    path, _ = map_spec
    argv = ["--infn", path, "--test", "--max-x", "31", "--num-rep", "3",
            "--show-mappings"]
    ref, batched = both(ref_crushtool.main, crushtool.main, argv)
    _, scalar = both(ref_crushtool.main, crushtool.main, argv + ["--scalar"])
    assert batched[1] == scalar[1] == ref[1]


def test_crushtool_roundtrip_spec(map_spec):
    path, cmap = map_spec
    ref, port = both(ref_crushtool.main, crushtool.main,
                     ["--infn", path, "--dump"])
    assert port[0] == 0 and port[1] == ref[1]
    assert json.loads(port[1]) == cmap.to_spec()


@pytest.mark.parametrize("verb", [["--tree"], ["-d"]])
def test_crushtool_tree_and_decompile(map_spec, verb):
    path, _ = map_spec
    argv = verb + [path] if verb == ["-d"] else ["--infn", path] + verb
    ref, port = both(ref_crushtool.main, crushtool.main, argv)
    assert port[:2] == ref[:2] and port[1]


def test_osdmaptool_test_map_pgs(map_spec, tmp_path):
    _, cmap = map_spec
    cluster = {
        "crush": cmap.to_spec(),
        "pools": [{"id": 1, "type": 1, "size": 3, "pg_num": 64,
                   "crush_rule": 0},
                  {"id": 2, "type": 3, "size": 4, "pg_num": 32,
                   "crush_rule": 0}],
        "osds": {"down": [], "out": []},
    }
    p = tmp_path / "cluster.json"
    p.write_text(json.dumps(cluster))
    ref, port = both(ref_osdmaptool.main, osdmaptool.main,
                     [str(p), "--test-map-pgs"])
    assert port[0] == ref[0] == 0
    assert port[1] == ref[1]
    assert "96 pgs" in port[2]       # timing line -> stderr (goldens)
    assert "total replicas 320" in port[1]


def test_osdmaptool_test_map_pgs_with_down_and_out(map_spec, tmp_path):
    _, cmap = map_spec
    cluster = {"crush": cmap.to_spec(),
               "pools": [{"id": 1, "type": 1, "size": 3, "pg_num": 128,
                          "crush_rule": 0}],
               "osds": {"down": [2], "out": [5, 7]}}
    p = tmp_path / "cluster.json"
    p.write_text(json.dumps(cluster))
    ref, port = both(ref_osdmaptool.main, osdmaptool.main,
                     [str(p), "--test-map-pgs"])
    assert port[:2] == ref[:2]
    ref_stats = ref_osdmaptool.test_map_pgs(
        ref_osdmaptool.load_cluster(cluster))
    port_stats = osdmaptool.test_map_pgs(
        osdmaptool.load_cluster(cluster, device="cpu"))
    for key in ("counts", "primaries"):
        assert (port_stats[key] == ref_stats[key]).all()


def test_osdmaptool_upmap(tmp_path):
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    ref = run(ref_osdmaptool.main, [str(CLUSTER_JSON), "--upmap",
                                    str(ref_out)])
    port = run(osdmaptool.main, [str(CLUSTER_JSON), "--upmap",
                                 str(port_out), "--device", "cpu"])
    assert port[:2] == ref[:2]
    assert port[1].startswith("balanced in ")
    assert json.loads(port_out.read_text()) == \
        json.loads(ref_out.read_text())
    assert json.loads(port_out.read_text())["pg_upmap_items"]


def test_osdmaptool_dump():
    ref, port = both(ref_osdmaptool.main, osdmaptool.main,
                     [str(CLUSTER_JSON), "--dump"])
    assert port[:2] == ref[:2]


def sweep_rows(stdout):
    """The CSV rows less the measured ``gbps`` column."""
    lines = stdout.splitlines()
    assert lines[0] == "plugin,technique,k,m,size,workload,gbps"
    return [ln.rsplit(",", 1)[0] for ln in lines[1:]]


def test_bench_sweep_rows_and_skipped_cells():
    argv = ["--plugins", "jax,jerasure,isa", "--sizes", "4096",
            "--iters", "1", "--batch", "2"]
    ref, port = both(ref_bench_sweep.main, bench_sweep.main, argv)
    assert port[0] == ref[0] == 0
    assert sweep_rows(port[1]) == sweep_rows(ref[1])
    for line in port[1].splitlines()[1:]:
        assert float(line.rsplit(",", 1)[1]) > 0
    # the cells that raise print the same lines in both packages
    skipped = [ln for ln in port[2].splitlines() if ln.startswith("# ")]
    assert skipped == [ln for ln in ref[2].splitlines()
                       if ln.startswith("# ")]
    assert skipped
    # every technique of every plugin is swept
    cells = {tuple(r.split(",")[:2]) for r in sweep_rows(port[1])}
    assert cells == {(p, t) for p, ts in bench_sweep.TECHNIQUES.items()
                     for t in ts}


def test_bench_sweep_cell_runs_on_the_codecs_device_path(monkeypatch):
    """A codec with a device path is timed through it, warm-up included,
    and never through the host-array batch API (no copy of its output
    to the host in the window)."""
    calls = []
    from ceph_tpu_torch.ec import instance
    codec = instance().factory("jax", {"k": "4", "m": "2"}, device="cpu")
    for name in ("encode_chunks_device", "decode_chunks_device",
                 "encode_chunks_batch", "decode_chunks_batch"):
        fn = getattr(codec, name)
        monkeypatch.setattr(codec, name,
                            lambda *a, _f=fn, _n=name: calls.append(_n)
                            or _f(*a))
    from ceph_tpu_torch import ec
    monkeypatch.setattr(type(ec.instance()), "factory",
                        lambda self, plugin, prof, device=None: codec)
    torch_dev = torch.device("cpu")
    assert bench_sweep.bench_cell("jax", "reed_sol_van", 4, 2, 4096,
                                  "encode", 3, 2, torch_dev) > 0
    assert calls == ["encode_chunks_device"] * 4
    calls.clear()
    assert bench_sweep.bench_cell("jax", "reed_sol_van", 4, 2, 4096,
                                  "decode", 3, 2, torch_dev) > 0
    assert calls.count("decode_chunks_device") == 4
    assert "decode_chunks_batch" not in calls


DEVICE_CLIS = {
    "crushtool": lambda d: crushtool.main(["-d", str(CLUSTER_JSON.parent /
                                                    "basic.crush"), *d]),
    "osdmaptool": lambda d: osdmaptool.main([str(CLUSTER_JSON), "--dump",
                                             *d]),
    "bench_sweep": lambda d: bench_sweep.main(["--sizes", "4096",
                                               "--iters", "1", *d]),
    "rados_cli": lambda d: rados_cli.main(["--dir", "/nonexistent", "-p",
                                           "rep", "ls", *d]),
    "cephadm": lambda d: cephadm.main([*d, "status", "/nonexistent"]),
}


@pytest.mark.parametrize("tool", sorted(DEVICE_CLIS))
def test_cli_device_defaults_to_cuda_and_raises_without_a_card(
        tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = ceph_tpu_torch.default_device()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(DEVICE_CLIS[tool], [])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(DEVICE_CLIS[tool], ["--device", "cuda"])
        # the package default is left as it was
        assert ceph_tpu_torch.default_device() == prev
    finally:
        ceph_tpu_torch.set_default_device(prev)
