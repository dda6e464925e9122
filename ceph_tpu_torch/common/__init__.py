"""Host-side substrate: options, perf counters, fault points (copies of
the NumPy-only ``ceph_tpu/common`` modules the EC data path needs)."""
