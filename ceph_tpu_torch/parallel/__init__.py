"""Multi-device scale-out.  Port of ``ceph_tpu/parallel``.

``mesh.py`` holds the mesh of cells, the splits and the sharded encode
steps; ``data_plane.py`` the cluster-level ``ShardedDataPlane`` behind
the ``parallel_data_plane`` option; ``multihost.py`` the fleet boot over
``torch.distributed`` and the legs that cross ranks.  No eager submodule
imports here: hot paths (plugin encode, ``map_pgs_batch``) import
``data_plane`` while the plane is off, so import the submodule you need
directly.
"""
