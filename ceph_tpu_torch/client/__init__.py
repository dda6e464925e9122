from .rados import IoCtx, Rados, ObjectNotFound
from .remote import RemoteCluster, RemoteObjectMissing
from .remote_ioctx import RemoteIoCtx, open_remote_ioctx
from .striper import RadosStriper

__all__ = ["IoCtx", "Rados", "ObjectNotFound", "RemoteCluster",
           "RemoteObjectMissing", "RemoteIoCtx", "open_remote_ioctx",
           "RadosStriper"]
