"""portbench: the benchmark of ``ceph_tpu_torch`` on one NVIDIA card.

Run one cell from the root of a checkout:

    python3 portbench/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>
"""
