"""Multi-device scale-out.  Port of ``ceph_tpu/parallel``.

Only ``multihost.py``'s single-process answers are ported; the mesh
and the sharded data plane (``mesh.py``, ``data_plane.py``) wait for
the multi-GPU plane.  No eager submodule imports here: import the
submodule you need directly, as the reference's package says.
"""
