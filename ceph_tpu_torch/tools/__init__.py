"""Offline tools: crushtool/osdmaptool/ec benchmark equivalents
(reference: src/tools/crushtool.cc, src/tools/osdmaptool.cc,
src/test/erasure-code/ceph_erasure_code_benchmark.cc)."""
