"""Whole-object reads (``Objecter.get``) of the configuration's image in
passes, each pass in an order drawn from the seed, with the hosts
``kill_hosts`` dead and not marked out (one failure epoch).

Set-up writes the image in batches of ``prefill_batch_objects``, then
kills the hosts and reads one object of each decode shape.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from portbench import arith
from portbench.generator import ECLoop, payloads


class Loop(ECLoop):

    def setup(self) -> None:
        t, cfg = self.t, self.cfg
        self.setup_image()
        self.datas = payloads(len(self.names), cfg["object_bytes"],
                              self.seed, self.device)
        self.prefill(self.datas, t["prefill_batch_objects"])
        ups = [self.up(nm) for nm in self.names]
        self.dead = {o for h in t["kill_hosts"]
                     for o in self.sys.host_osds[h]}
        sim, mon = self.sys.sim, self.sys.mon
        inc = mon.next_incremental()
        for o in sorted(self.dead):
            sim.fail_osd(o)
            inc.new_up[o] = False
        if not mon.commit_incremental(inc):
            raise RuntimeError("the monitor refused the failure epoch")
        # erased data chunks per object, from where the program placed it
        self.erased = [sum(u[j] in self.dead for j in range(cfg["k"]))
                       for u in ups]
        # passes over the image, each in an order drawn from the seed:
        # every seed reads the same objects as often
        self.order = np.concatenate([self.rng.permutation(len(self.names))
                                     for _ in range(max(1, (1 << 20) //
                                                        len(self.names)))])
        self.pos = 0
        warm = {}
        for i, e in enumerate(self.erased):
            warm.setdefault(e, i)
        for i in warm.values():          # each decode shape once
            self.read(i)
        self.ops.clear()
        self.got: List[tuple] = []
        self.work = {"codec_bytes": 0, "bytes_read": 0}

    def read(self, i: int):
        get = self.hooks.get("get", self.sys.client.get)
        return self.timed("get", lambda: get(self.sys.pool_id,
                                             self.names[i]), obj=i)

    def step(self) -> None:
        i = int(self.order[self.pos % len(self.order)])
        self.pos += 1
        data = self.read(i)
        self.got.append((i, data))
        if data is not None:
            cfg = self.cfg
            self.work["bytes_read"] += len(data)
            self.work["codec_bytes"] += arith.decode_bytes(
                self.S, cfg["k"], self.erased[i], self.U)

    def check(self) -> Dict[str, tuple]:
        wrong = sum(d is not None and d != self.datas[i]
                    for i, d in self.got)
        return {"wrong_reads": (wrong, 0), "failed_ops": (self.failed, 0)}
