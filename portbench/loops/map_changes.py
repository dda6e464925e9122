"""Map epochs on a replicated pool: one host (drawn from the seed) out,
then the same host back in, alternating; after each epoch
``OSDMap.map_pgs_batch`` maps the whole pool.  The mix has no
parameters but its ``kind``."""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from portbench import arith
from portbench.generator import Loop as Base
from portbench.reference import straw2


class Loop(Base):

    def setup(self) -> None:
        from ceph_tpu_torch.native_bridge import NativeMapper
        om = self.sys.osdmap
        NativeMapper(om.crush)           # the host mapper's build
        self.out_host = None
        self.sweeps: List[tuple] = []
        self.work = {"pgs_mapped": 0}
        self.sweep()                     # the map as the monitor has it
        self.step()                      # the warm-up: one host out
        self.ops.clear()
        self.sweeps.clear()
        self.work = {"pgs_mapped": 0}

    @classmethod
    @contextlib.contextmanager
    def control(cls):
        """A map one epoch behind: each sweep serves the up sets of the
        one before it."""
        def hooks(loop):
            real, prev = loop.sys.osdmap.map_pgs_batch, []

            def sweep(pool_id, pss=None):
                up = real(pool_id, pss)
                prev.append(up)
                return prev[-2] if len(prev) > 1 else up
            return {"map_pgs_batch": sweep}
        yield hooks

    def sweep(self):
        sweep = self.hooks.get("map_pgs_batch", self.sys.osdmap.map_pgs_batch)
        up = self.timed("sweep", lambda: sweep(self.sys.pool_id)[0],
                        pgs=self.cfg["pg_num"])
        if up is not None:
            self.sweeps.append((self.out_host, np.asarray(up)))
        return up

    def step(self) -> None:
        from ceph_tpu_torch.cluster.osdmap import Incremental
        om = self.sys.osdmap
        if self.out_host is None:
            self.out_host = int(self.rng.integers(len(self.sys.host_osds)))
            w = 0
        else:
            w = arith.WEIGHT_IN
        inc = Incremental(epoch=om.epoch + 1, new_weight={
            o: w for o in self.sys.host_osds[self.out_host]})
        om.apply_incremental(inc)
        if w:
            self.out_host = None
        if self.sweep() is not None:
            self.work["pgs_mapped"] += self.cfg["pg_num"]

    def check(self) -> Dict[str, tuple]:
        """Every lane of every sweep against the reference's map for its
        epoch: one full map with every host in, and for each host taken
        out only the lanes whose up set held it (``HostOutMaps``), so
        the check costs at most ``size`` + 1 full maps, however many
        sweeps the window held."""
        cfg = self.cfg
        x = straw2.pps(cfg["pool_id"], cfg["pg_num"], self.device)
        maps = straw2.HostOutMaps(x, cfg["hosts"], cfg["osds_per_host"],
                                  cfg["size"], {h for h, _ in self.sweeps
                                                if h is not None})
        wrong = 0
        for host, up in self.sweeps:
            got = torch.as_tensor(up.astype(np.int64), device=self.device)
            wrong += int((got != maps.up(host)).any(1).sum())
        self.work["draws"] = sum(maps.draws(h) for h, _ in self.sweeps)
        return {"wrong_lanes": (wrong, 0), "failed_ops": (self.failed, 0)}
