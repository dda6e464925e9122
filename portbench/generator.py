"""The traffic generator's common part: what every loop shares.

A traffic mix is a JSON file of parameters, ``traffic/<mix>.json``; its
``kind`` names the loop that runs it, ``loops/<kind>.py``, whose class
``Loop`` derives from ``Loop`` or ``ECLoop`` here.  Each loop makes its
inputs from the seed at set-up, warms up the shapes its traffic uses,
then runs a closed loop of one client: the next operation starts when
the previous one has returned (and the card has finished it).  The window runs whole operations until
``seconds`` have passed; its length is the time to the end of the last
one, so every rate counts all the work and all the time of the window.

After the window, ``collect`` takes from the program what the check
judges (stored shards, bytes read, up sets), the system is freed, and
``check`` holds it against the plain reference.  Each check returns
``{name: (value, limit)}``; every comparison is exact, so every limit
is 0.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List

import numpy as np
import torch

from .reference import rs

NONE = 0x7FFFFFFF
RETRIES = 4          # writes are retried until every shard acks


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def payloads(n: int, nbytes: int, seed: int, device) -> List[bytes]:
    """``n`` payloads of ``nbytes`` random bytes from ``seed``, drawn on
    the device in blocks of 64 and copied to the host once."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for lo in range(0, n, 64):
        blk = torch.randint(0, 256, (min(64, n - lo), nbytes),
                            dtype=torch.uint8, generator=g, device=device)
        out += [row.tobytes() for row in blk.cpu().numpy()]
    return out


def object_name(i: int) -> str:
    """An RBD data object's name: rbd_data.<image id>.<object number>."""
    return f"rbd_data.portbench.{i:016x}"


class Loop:
    """One mix's closed loop over one system.

    ``hooks`` put another callable in the place of one the loop drives
    (by the name the loop looks it up under): the controls and the
    tests' planted faults use them, the benchmark's runs never do."""

    def __init__(self, system, traffic: Dict[str, Any], seed: int,
                 device):
        self.sys = system
        self.cfg = system.cfg
        self.t = traffic
        self.seed = seed
        self.device = device
        self.hooks: Dict[str, Any] = {}
        self.rng = np.random.default_rng(seed)
        self.ops: List[Dict[str, Any]] = []
        self.work: Dict[str, float] = {}
        self.failed = 0

    def run_window(self, seconds: float) -> float:
        """Run whole operations until ``seconds`` have passed; returns the
        window's length."""
        sync(self.device)
        t0 = time.perf_counter()
        while True:
            self.step()
            sync(self.device)
            if time.perf_counter() - t0 >= seconds:
                return time.perf_counter() - t0

    @classmethod
    @contextlib.contextmanager
    def control(cls):
        """Put the mix's control in the program's place for the block;
        yields a function that gives a built loop the control's hooks."""
        raise NotImplementedError(f"{cls.__module__} has no control")
        yield

    def collect(self) -> None:
        """Take from the program what ``check`` judges, before the
        system is freed."""

    def timed(self, kind: str, fn, **rec):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("portbench." + kind):
                out = fn()
        except IOError as e:
            self.failed += 1
            rec["error"] = f"{type(e).__name__}: {e}"
            out = None
        sync(self.device)
        rec.update(kind=kind, t0=t0, t1=time.perf_counter())
        self.ops.append(rec)
        return out


# ------------------------------------------------------------ EC pools --

class ECLoop(Loop):

    def setup_image(self) -> None:
        """The configuration's image: ``image_objects`` objects of
        ``object_bytes``, each ``S`` stripes of k units of ``U`` bytes."""
        cfg = self.cfg
        self.S = max(1, -(-cfg["object_bytes"] //
                          (cfg["k"] * cfg["stripe_unit"])))
        self.U = cfg["stripe_unit"]
        self.names = [object_name(i) for i in range(cfg["image_objects"])]

    def put_all(self, names: List[str], datas: List[bytes]) -> None:
        """Objecter.put_many, then again for any object that landed fewer
        than k + m shards, until all of them ack."""
        sys_ = self.sys
        todo = list(range(len(names)))
        for _ in range(RETRIES):
            placed = sys_.client.put_many(sys_.pool_id,
                                          [names[i] for i in todo],
                                          [datas[i] for i in todo])
            todo = [i for i in todo
                    if len(placed.get(names[i], ())) < sys_.shards]
            if not todo:
                return
        raise IOError(f"{len(todo)} objects never acked all "
                      f"{sys_.shards} shards")

    @classmethod
    @contextlib.contextmanager
    def control(cls):
        """The EC control: the code weakened (``control.weaker_code``),
        every operation's error counted as a failed one."""
        from .control import guarded, weaker_code
        with weaker_code():
            yield lambda loop: {"put_all": guarded(loop.put_all),
                                "get": guarded(loop.sys.client.get)}

    def prefill(self, datas: List[bytes], batch: int) -> None:
        for lo in range(0, len(self.names), batch):
            self.put_all(self.names[lo:lo + batch], datas[lo:lo + batch])

    def up(self, name: str) -> List[int]:
        sim = self.sys.sim
        pool = sim.osdmap.pools[self.sys.pool_id]
        return list(sim.pg_up(pool, sim.object_pg(pool, name)))

    def stored_shards(self, names: List[str]):
        """Each object's shards as the program stored them on its current
        up set: {name: [bytes or None] * (k + m)}."""
        sim, pid = self.sys.sim, self.sys.pool_id
        pool = sim.osdmap.pools[pid]
        out = {}
        for nm in names:
            pg = sim.object_pg(pool, nm)
            up = sim.pg_up(pool, pg)
            row = []
            for j in range(self.sys.shards):
                o = up[j] if j < len(up) else NONE
                a = None if o == NONE else sim.osds[o].get((pid, pg, nm, j))
                row.append(None if a is None else a.tobytes())
            out[nm] = row
        return out

    def wrong_shards(self, stored, expect: Dict[str, bytes]) -> int:
        """Shards missing from their up set or differing from the
        reference's encoding of the payload, in blocks of 64 objects."""
        k, m = self.cfg["k"], self.cfg["m"]
        S, U = self.S, self.U
        names = sorted(expect)
        wrong = 0
        for lo in range(0, len(names), 64):
            blk = names[lo:lo + 64]
            data = torch.stack([
                torch.frombuffer(bytearray(expect[nm].ljust(S * k * U,
                                                             b"\0")),
                                 dtype=torch.uint8).view(S, k, U)
                for nm in blk]).to(self.device).view(len(blk) * S, k, U)
            full = torch.cat([data, rs.encode(k, m, data)], 1) \
                .view(len(blk), S, k + m, U)
            for i, nm in enumerate(blk):
                for j, got in enumerate(stored[nm]):
                    if got is None or len(got) != S * U:
                        wrong += 1
                        continue
                    have = torch.frombuffer(bytearray(got),
                                            dtype=torch.uint8) \
                        .view(S, U).to(self.device)
                    wrong += int(not torch.equal(have, full[i, :, j]))
        return wrong
