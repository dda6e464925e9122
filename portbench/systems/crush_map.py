"""A replicated pool on an ``OSDMap`` of the flat straw2 map, built
through the port's public entry points."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

from portbench import flatmap


@dataclass
class CrushMap:
    cfg: Dict[str, Any]
    osdmap: Any
    pool_id: int
    host_osds: List[List[int]]

    def close(self) -> None:
        pass


def build(cfg, device) -> CrushMap:
    from ceph_tpu_torch.cluster.osdmap import OSDMap, PGPool, \
        POOL_REPLICATED
    from ceph_tpu_torch.placement.crush_map import Tunables
    cmap, hosts = flatmap.build(cfg)
    if vars(cmap.tunables) != vars(Tunables.profile(cfg["tunables"])):
        raise ValueError(f"the map's tunables are not {cfg['tunables']}")
    om = OSDMap(cmap, device=device)
    om.mark_all_in_up()
    om.add_pool(PGPool(id=cfg["pool_id"], name=cfg["name"],
                       type=POOL_REPLICATED, size=cfg["size"],
                       pg_num=cfg["pg_num"], crush_rule=0))
    return CrushMap(cfg, om, cfg["pool_id"], hosts)
