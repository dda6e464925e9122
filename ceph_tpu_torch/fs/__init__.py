"""File-system layer: the journaler (src/journal/ role).

Port of ``ceph_tpu/fs/__init__.py``.  The reference's package also
exports the metadata server slice (``mds``, ``mdsmap``, ``multimds``);
those modules are not ported yet, so this namespace holds only
``Journaler``.
"""
from .journaler import Journaler  # noqa: F401
