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
               block: int = 1 << 14, host_ids=None,
               osd_weights=None) -> Tuple[torch.Tensor, int]:
    """Up sets [N, numrep] (NONE after the last OSD found) and the number
    of straw2 draws made, retries included.

    The map is the configuration's unless told otherwise: host h is
    bucket ``host_ids[h]`` (default -1-h) and OSD j of host h has crush
    weight ``osd_weights[h, j]`` (default 0x10000); a host weighs the
    sum of its OSDs'."""
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
    outs, draws = [], 0
    for lo in range(0, len(x), block):
        xb = x[lo:lo + block].to(torch.int64)
        n = len(xb)
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
                draws += len(act) * hosts
                collide = (hosts_out[act] == h[:, None]).any(1)
                osd_ids = h[:, None] * per_host + torch.arange(
                    per_host, device=dev)
                leaf = h * per_host + _draw(xa, osd_ids, r, osd_w[h], ln)
                draws += int((~collide).sum()) * per_host
                w = rw[leaf]
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
    return torch.cat(outs), draws
