"""The port's ``ec_bench`` tool (``ceph_tpu_torch/tools/ec_bench.py``)
against the reference's, on the CPU: the same arguments give the same
chunk size, erasures and KB count, in ``--json`` and in the
``seconds\\tKB`` line; without a card and without ``--device cpu`` the
tool raises."""
import json

import pytest
import torch

from ceph_tpu.tools import ec_bench as ref_bench
from ceph_tpu_torch.tools import ec_bench

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

KEYS = ("plugin", "workload", "k", "m", "chunk_size", "batch",
        "iterations", "erased", "KB")
RUNS = {
    "jax-encode-batch": ["--plugin", "jax", "--workload", "encode",
                         "-k", "4", "-m", "2", "--size", "65536",
                         "--iterations", "2", "--batch", "4"],
    "jerasure-decode": ["--plugin", "jerasure", "--workload", "decode",
                        "-k", "4", "-m", "2", "--size", "16384",
                        "--iterations", "1", "--erasures", "2"],
    "jerasure-liber8tion-decode-batch": [
        "--plugin", "jerasure", "--technique", "liber8tion",
        "--workload", "decode", "-k", "6", "-m", "2", "-P", "w=8",
        "--size", "49152", "--iterations", "2", "--batch", "3",
        "--erased", "1", "--erased", "7"],
    "clay-encode": ["--plugin", "clay", "--workload", "encode", "-k", "4",
                    "-m", "2", "-P", "d=5", "--size", "8192",
                    "--iterations", "1"],
}


def run_json(main, argv, capsys):
    assert main(argv + ["--json"]) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("name", list(RUNS))
def test_ec_bench_json_equals_reference(name, capsys):
    argv = RUNS[name]
    got = run_json(ec_bench.main, argv + ["--device", "cpu"], capsys)
    want = run_json(ref_bench.main, argv, capsys)
    assert {k: got[k] for k in KEYS} == {k: want[k] for k in KEYS}
    assert got["device"] == "cpu"
    stripes = got["iterations"] * got["batch"]
    assert got["KB"] == stripes * got["k"] * got["chunk_size"] // 1024
    assert got["seconds"] > 0 and got["GBps"] > 0
    if got["workload"] == "decode":
        assert len(got["erased"]) == 2


def test_ec_bench_prints_seconds_tab_kb(capsys):
    argv = RUNS["jax-encode-batch"]
    assert ec_bench.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr()
    seconds, kb = out.out.strip().split("\t")
    assert float(seconds) > 0 and int(kb) == 2 * 4 * 4 * 16384 // 1024
    assert "GB/s payload (jax encode k=4 m=2 batch=4)" in out.err


def test_ec_bench_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ec_bench.main(["--plugin", "jerasure", "-k", "4", "-m", "2",
                       "--size", "4096", "--iterations", "1"])
