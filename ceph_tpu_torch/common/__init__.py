"""Host-side substrate: options, perf counters, fault points, lockdep,
the tracer, the op tracker, compile/build attribution, the crc32 combine
algebra, session crypto and compressors (copies of the NumPy-only
``ceph_tpu/common`` modules the cluster step and the wire tier need)."""
