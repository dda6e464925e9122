"""File-system layer: journaler + metadata server slice (src/journal/
+ src/mds/ roles)."""
from .journaler import Journaler  # noqa: F401
from .mds import MDS, CephFSClient, ForwardError, FSError  # noqa: F401
from .mdsmap import MDSMap  # noqa: F401
from .multimds import MDBalancer, MDSCluster  # noqa: F401
