"""Manager layer: module host + standard modules (src/mgr/ +
src/pybind/mgr/ roles)."""
from .module_host import MgrModule, MgrModuleHost  # noqa: F401
