"""A straw2 ``CHOOSELEAF_FIRSTN`` mapper that counts its draws.

The map is flat, as the configuration states it: a straw2 root whose
items are ``hosts`` straw2 host buckets (host h is bucket -1-h), each
holding ``osds_per_host`` OSDs (host h holds OSDs h*per .. h*per+per-1),
every OSD of crush weight 0x10000 and every host of the sum of its OSDs'.
The rule is ``TAKE root / CHOOSELEAF_FIRSTN 0 host / EMIT`` under the
jewel tunables (choose_total_tries 50, no local retries,
chooseleaf_descend_once, chooseleaf_vary_r 1, chooseleaf_stable 1), as
src/crush/mapper.c runs it:

* replica ``rep`` tries r = rep + ftotal: a straw2 draw over the root's
  hosts picks a host; a host already chosen collides;
* else one straw2 draw over the host's OSDs with the same r picks an
  OSD, which is out when its reweight is 0, or below 0x10000 and
  hash2(x, osd) & 0xffff >= reweight;
* a collision or an out OSD costs one try (ftotal + 1); after 51 tries
  the replica is skipped and the up set comes out shorter.

A straw2 draw of item i is trunc(ln(u) / w_i) with
u = hash3(x, id_i, r) & 0xffff, ln(u) = crush_ln(u) - 2^48 and w_i the
item's crush weight; the first largest draw wins.  ``crush_ln`` is
Ceph's fixed-point log (src/crush/crush_ln_table.h), held here as a
65,536-entry table.  Hashes are Robert Jenkins' 32-bit mix
(src/crush/hash.c), computed in int64 and masked to 32 bits.

Lanes run as one batch on whatever device ``x`` is on.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
SEED = 1315423911
MIX_X, MIX_Y = 231232, 1232
WEIGHT_ONE = 0x10000
NONE = 0x7FFFFFFF
TRIES = 51

_LN = np.load(os.path.join(os.path.dirname(__file__), "crush_ln_u16.npy"))


def _mix(a, b, c):
    a = (a - b - c) & M32
    a = a ^ (c >> 13)
    b = (b - c - a) & M32
    b = (b ^ (a << 8)) & M32
    c = (c - a - b) & M32
    c = c ^ (b >> 13)
    a = (a - b - c) & M32
    a = a ^ (c >> 12)
    b = (b - c - a) & M32
    b = (b ^ (a << 16)) & M32
    c = (c - a - b) & M32
    c = c ^ (b >> 5)
    a = (a - b - c) & M32
    a = a ^ (c >> 3)
    b = (b - c - a) & M32
    b = (b ^ (a << 10)) & M32
    c = (c - a - b) & M32
    c = c ^ (b >> 15)
    return a, b, c


def hash2(a, b):
    h = SEED ^ a ^ b
    x, y = MIX_X, MIX_Y
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def hash3(a, b, c):
    h = SEED ^ a ^ b ^ c
    x, y = MIX_X, MIX_Y
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def pps(pool_id: int, pg_num: int, device) -> torch.Tensor:
    """Placement seeds of PGs 0 .. pg_num-1 of a hashpspool pool
    (ceph_stable_mod, then hash2(ps, pool))."""
    mask = (1 << (pg_num - 1).bit_length()) - 1
    ps = torch.arange(pg_num, dtype=torch.int64, device=device)
    sm = torch.where((ps & mask) < pg_num, ps & mask, ps & (mask >> 1))
    return hash2(sm, torch.full_like(sm, pool_id))


def _draw(x, ids, r, weight, ln: torch.Tensor) -> torch.Tensor:
    """Index of the winning item: x, r [n]; ids [n, S] (32-bit ids);
    ``weight`` the items' crush weights, [S] or [n, S].  An item of
    weight 0 draws the least int64."""
    u = hash3(x[:, None], ids, r[:, None]) & 0xFFFF
    draw = torch.div(ln[u], weight.clamp(min=1), rounding_mode="trunc")
    draw = torch.where(weight > 0, draw, torch.iinfo(torch.int64).min)
    return torch.argmax(draw, dim=1)      # first largest


def map_firstn(x: torch.Tensor, hosts: int, per_host: int,
               reweight: torch.Tensor, numrep: int,
               block: int = 1 << 14, host_ids=None, osd_weights=None,
               out_host=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up sets [N, numrep] (NONE after the last OSD found) and each
    lane's number of straw2 draws, retries included [N].

    The map is the configuration's unless told otherwise: host h is
    bucket ``host_ids[h]`` (default -1-h) and OSD j of host h has crush
    weight ``osd_weights[h, j]`` (default 0x10000); a host weighs the
    sum of its OSDs'.  ``out_host`` [N], where given, takes lane i's own
    host ``out_host[i]`` out (reweight 0 for its OSDs; -1: none)."""
    dev = x.device
    ln = torch.as_tensor(_LN, device=dev) - (1 << 48)
    if host_ids is None:
        host_ids = -1 - torch.arange(hosts, dtype=torch.int64)
    host_ids = torch.as_tensor(host_ids, dtype=torch.int64).to(dev) & M32
    if osd_weights is None:
        osd_weights = torch.full((hosts, per_host), WEIGHT_ONE,
                                 dtype=torch.int64)
    osd_w = torch.as_tensor(osd_weights, dtype=torch.int64).to(dev)
    host_w = osd_w.sum(1)
    rw = reweight.to(dev, torch.int64)
    if out_host is None:
        out_host = torch.full((len(x),), -1, dtype=torch.int64)
    out_host = torch.as_tensor(out_host, dtype=torch.int64).to(dev)
    outs, draws = [], []
    for lo in range(0, max(len(x), 1), block):    # no lanes: one empty
        xb = x[lo:lo + block].to(torch.int64)
        ob = out_host[lo:lo + block]
        n = len(xb)
        nd = torch.zeros(n, dtype=torch.int64, device=dev)
        hosts_out = torch.full((n, numrep), -1, dtype=torch.int64,
                               device=dev)
        leaves = torch.full((n, numrep), NONE, dtype=torch.int64,
                            device=dev)
        outpos = torch.zeros(n, dtype=torch.int64, device=dev)
        for rep in range(numrep):
            ftotal = torch.zeros(n, dtype=torch.int64, device=dev)
            act = torch.arange(n, device=dev)
            while len(act):
                xa, r = xb[act], rep + ftotal[act]
                h = _draw(xa, host_ids.expand(len(act), hosts), r,
                          host_w, ln)
                nd[act] += hosts
                collide = (hosts_out[act] == h[:, None]).any(1)
                osd_ids = h[:, None] * per_host + torch.arange(
                    per_host, device=dev)
                leaf = h * per_host + _draw(xa, osd_ids, r, osd_w[h], ln)
                nd[act[~collide]] += per_host
                w = torch.where(h == ob[act], 0, rw[leaf])
                out = (w == 0) | ((w < WEIGHT_ONE) &
                                  ((hash2(xa, leaf) & 0xFFFF) >= w))
                ok = ~collide & ~out
                acc, pos = act[ok], outpos[act[ok]]
                hosts_out[acc, pos] = h[ok]
                leaves[acc, pos] = leaf[ok]
                outpos[acc] += 1
                ftotal[act[~ok]] += 1
                act = act[~ok & (ftotal[act] < TRIES)]
        outs.append(leaves)
        draws.append(nd)
    return torch.cat(outs), torch.cat(draws)


class HostOutMaps:
    """The all-in map and, for each host of ``outs``, the map with that
    host's OSDs out (reweight 0; every other OSD in), each with its
    draw count, for the cost of one full map and the lanes that each
    host touches.

    That is exact.  In the all-in map no draw is rejected as out, and a
    try that draws host h and collides does so whether h is out or not.
    So with h out, a lane whose all-in up set holds no OSD of h makes
    the same draws and comes to the same up set.  Only the lanes whose
    all-in up set holds an OSD of h are mapped again: every host's in
    one call, each lane with its own host out.  A lane holds at most
    ``numrep`` hosts, so that call maps at most ``numrep`` x N lanes,
    however many hosts are out."""

    def __init__(self, x: torch.Tensor, hosts: int, per_host: int,
                 numrep: int, outs):
        rw = torch.full((hosts * per_host,), WEIGHT_ONE, dtype=torch.int64)
        self.base, self.base_draws = map_firstn(x, hosts, per_host, rw,
                                                numrep)
        self.total = int(self.base_draws.sum())
        held = self.base // per_host          # NONE // per_host is no host
        lanes = {h: torch.nonzero((held == h).any(1)).flatten()
                 for h in sorted(set(outs))}
        none = self.base_draws[:0]            # no lanes, if no host is out
        up, draws = map_firstn(
            x[torch.cat([none, *lanes.values()])], hosts, per_host, rw,
            numrep, out_host=torch.cat(
                [none, *(torch.full_like(i, h) for h, i in lanes.items())]))
        sizes = [len(i) for i in lanes.values()]
        self.patch = {h: p for h, *p in zip(lanes, lanes.values(),
                                            up.split(sizes),
                                            draws.split(sizes))}

    def up(self, host) -> torch.Tensor:
        """Up sets [N, numrep] with ``host`` out (None: all in)."""
        if host is None:
            return self.base
        lanes, up, _ = self.patch[host]
        out = self.base.clone()
        out[lanes] = up
        return out

    def draws(self, host) -> int:
        """Draws of the whole map with ``host`` out (None: all in)."""
        if host is None:
            return self.total
        lanes, _, d = self.patch[host]
        return self.total - int(self.base_draws[lanes].sum()) + int(d.sum())
