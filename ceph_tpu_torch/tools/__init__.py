"""Offline tools of the port: the erasure-code benchmark, the
ceph_erasure_code_benchmark equivalent
(src/test/erasure-code/ceph_erasure_code_benchmark.cc)."""
