"""Host-side substrate: options, perf counters, fault points, lockdep,
the tracer, the op tracker and compile/build attribution (copies of the
NumPy-only ``ceph_tpu/common`` modules the cluster step needs)."""
