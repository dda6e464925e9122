"""The plain references the benchmark judges the port against.

Plain NumPy and PyTorch.  Nothing here imports the port
(``ceph_tpu_torch``), the JAX package or JAX, and nothing loads the
native mapper's library: each module works out again, from the inputs
the harness gave both sides, what the harness compares.

* ``rs``: GF(2^8) Reed-Solomon (``reed_sol_van``) over the bitsliced
  chunk layout, encode and decode.
* ``straw2``: a straw2 ``CHOOSELEAF_FIRSTN`` mapper over a flat map of
  host buckets that counts its draws.
"""
