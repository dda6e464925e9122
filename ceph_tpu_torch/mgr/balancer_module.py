"""Balancer mgr module — wraps the upmap optimizer as a module
(src/pybind/mgr/balancer/module.py calling OSDMap::calc_pg_upmaps)."""
from __future__ import annotations

from ..cluster.balancer import BalanceResult, calc_pg_upmaps
from .module_host import MgrModule


class BalancerModule(MgrModule):
    NAME = "balancer"

    def __init__(self, host):
        super().__init__(host)
        self.mode = "upmap"
        self.last_result: BalanceResult | None = None

    def optimize(self, **kw) -> BalanceResult:
        self.last_result = calc_pg_upmaps(self.get("osd_map"), **kw)
        return self.last_result

    def eval(self, cluster_stats, **kw) -> dict:
        """Dry-run advisor (`ceph balancer eval`): score the current
        mapping from heat x utilization and return proposed moves as
        a report — calc_pg_upmaps MUTATES the map, this never does."""
        from .balancer_advisor import evaluate
        return evaluate(self.get("osd_map"), cluster_stats, **kw)

    def serve_tick(self) -> None:
        self.optimize()


def register(host) -> None:
    host.register(BalancerModule.NAME, BalancerModule)
