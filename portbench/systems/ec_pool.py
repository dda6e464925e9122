"""An erasure-coded pool on a ``ClusterSim``, with a ``Monitor`` that
owns its map and one ``Objecter`` client, built through the port's
public entry points."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

from portbench import flatmap


@dataclass
class ECPool:
    cfg: Dict[str, Any]
    sim: Any
    mon: Any
    client: Any
    pool_id: int
    host_osds: List[List[int]]

    @property
    def shards(self) -> int:
        return self.cfg["k"] + self.cfg["m"]

    def close(self) -> None:
        self.sim.shutdown()


def build(cfg, device) -> ECPool:
    from ceph_tpu_torch.cluster.monitor import Monitor
    from ceph_tpu_torch.cluster.objecter import Objecter
    from ceph_tpu_torch.cluster.osdmap import OSDMap, PGPool, POOL_ERASURE
    from ceph_tpu_torch.cluster.simulator import ClusterSim
    cmap, hosts = flatmap.build(cfg)
    om = OSDMap(cmap, device=device)
    om.mark_all_in_up()
    pid = cfg["pool_id"]
    om.add_pool(PGPool(id=pid, name=cfg["name"], type=POOL_ERASURE,
                       size=cfg["k"] + cfg["m"], pg_num=cfg["pg_num"],
                       crush_rule=0, erasure_code_profile=cfg["name"],
                       stripe_unit=cfg["stripe_unit"]))
    sim = ClusterSim(om, device=device)
    sim.create_ec_profile(cfg["name"], {
        "plugin": cfg["plugin"], "technique": cfg["technique"],
        "k": str(cfg["k"]), "m": str(cfg["m"]),
        "crush-failure-domain": cfg["crush_failure_domain"]})
    mon = Monitor(sim.osdmap)
    return ECPool(cfg, sim, mon, Objecter(sim, mon), pid, hosts)
