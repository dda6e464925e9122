"""Sequential writes of the configuration's image in batches
(``Objecter.put_many``), wrapping round and overwriting.

Set-up writes the whole image once (pass 0) and one batch more, so every
batch of the window overwrites an object that is there.  Pass p writes
object i with payload (i + p) % ``payloads``, so every pass changes
every object.  The mix: ``batch_objects`` objects a batch, ``payloads``
distinct payloads made on the card from the seed at set-up.
"""
from __future__ import annotations

from typing import Dict

from portbench import arith
from portbench.generator import ECLoop, payloads


class Loop(ECLoop):

    def __init__(self, *a):
        super().__init__(*a)
        self.work = {"bytes_acked": 0, "codec_bytes": 0, "objects": 0}

    def setup(self) -> None:
        t = self.t
        self.setup_image()
        self.datas = payloads(t["payloads"], self.cfg["object_bytes"],
                              self.seed, self.device)
        self.last: Dict[int, int] = {}
        self.batch = 0
        n, B = len(self.names), t["batch_objects"]
        for _ in range(-(-n // B) + 1):  # the image, then one overwrite
            self.step()
        self.ops.clear()
        self.work = {k: 0 for k in self.work}

    def step(self) -> None:
        t, n, B = self.t, len(self.names), self.t["batch_objects"]
        first = self.batch * B
        idx = [(first + j) % n for j in range(B)]
        pas = first // n
        pick = [(i + pas) % t["payloads"] for i in idx]
        self.batch += 1
        names = [self.names[i] for i in idx]
        datas = [self.datas[p] for p in pick]
        put = self.hooks.get("put_all", self.put_all)
        if self.timed("put_many", lambda: put(names, datas) or True,
                      objects=B) is None:
            return
        self.last.update(zip(idx, pick))
        cfg = self.cfg
        self.work["bytes_acked"] += sum(len(d) for d in datas)
        self.work["objects"] += B
        self.work["codec_bytes"] += arith.encode_bytes(
            B, self.S, cfg["k"], cfg["m"], self.U)

    def collect(self) -> None:
        self.stored = self.stored_shards(
            [self.names[i] for i in self.last])
        picks = self.rng.choice(sorted(self.last), min(8, len(self.last)),
                                replace=False)
        self.readback = {int(i): self.get_or_none(self.names[int(i)])
                         for i in picks}

    def get_or_none(self, name: str):
        try:
            return self.sys.client.get(self.sys.pool_id, name)
        except (IOError, KeyError):      # unreadable, or never written
            return None

    def check(self) -> Dict[str, tuple]:
        expect = {self.names[i]: self.datas[p]
                  for i, p in self.last.items()}
        bad_reads = sum(got != self.datas[self.last[i]]
                        for i, got in self.readback.items())
        return {"wrong_shards": (self.wrong_shards(self.stored, expect), 0),
                "wrong_readbacks": (bad_reads, 0),
                "failed_ops": (self.failed, 0)}
