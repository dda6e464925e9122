"""Small sizes for CPU runs of the benchmark's cells: the published
shapes (RS(8,3), 4 KiB stripe units, straw2 chooseleaf) on small maps,
pools and images."""
import json

from portbench.tests.conftest import ROOT

EC = {"hosts": 14, "osds_per_host": 1, "pg_num": 16, "object_bytes": 65536,
      "image_objects": 16}
CELLS = {
    "rbd_ec_k8m3.ingest": (EC, {"batch_objects": 4, "payloads": 4}),
    "rbd_ec_k8m3.degraded_read": (EC, {"prefill_batch_objects": 8,
                                       "kill_hosts": [0, 5, 9]}),
    "crush_10k_rep3.remap": ({"hosts": 40, "osds_per_host": 5,
                              "pg_num": 2048}, {}),
}


def bench():
    """The manifest with the parked cells."""
    from portbench import harness
    return harness.with_parked(
        json.loads((ROOT / "BENCHMARK.json").read_text()))


def run(workload, seed=2 ** 31 + 17, seconds=0.5, hooks=None, trace=False,
        root=ROOT, manifest=None):
    """One run of ``workload`` on the CPU (the test hook: no look for a
    card), at the small sizes above."""
    from portbench import harness
    cfg, mix = CELLS.get(workload, ({}, {}))
    return harness.run_cell(root, manifest or bench(), workload, seed,
                            seconds, trace, "cpu", hooks=hooks,
                            config_override=cfg, traffic_override=mix)


def control(workload, seed=2 ** 31 + 17, seconds=0.5):
    """One run of ``workload`` on the CPU with its control in the
    program's place."""
    from portbench import harness
    cfg, mix = CELLS[workload]
    return harness.run_cell(ROOT, bench(), workload, seed, seconds, False,
                            "cpu", control=True, config_override=cfg,
                            traffic_override=mix)
