"""Carry state between the reference package and the port.

Nothing here imports the reference package: a reference object is read
through its attributes only, so every ``*_state`` function works on
either package's value.

  * Staged EC shards cross as NumPy: ``entries`` maps a ShardKey to
    ``(words, csum)``, where ``words`` is one shard's flat int32 plane
    words (the reference package's staged shard read out with
    ``np.asarray(ref.materialize())``) and ``csum`` its durable checksum,
    or None for a dirty entry.  Codec parameters cross as the profile
    dict: one profile builds the same codec in both packages.
  * A CRUSH map crosses as ``crush_map_state``: buckets (id, type, alg,
    hash, items, weights and the derived straw/list/tree tables), rules
    as step lists, tunables, ``choose_args`` weight sets and the name
    tables, as plain ints and NumPy arrays.
  * An OSDMap crosses as ``osdmap_state``: that crush state plus the
    OSD weights and up/in/exists flags, primary affinity, the pools as
    PGPool fields, pg_temp, primary_temp and the upmap tables.
  * A ``crcutil.Csums`` (the wire tier's per-4 KiB sub-crcs of one
    payload) crosses as ``csums_state``: its ``block``, ``subs`` and
    ``length``; ``combined`` is derived again on arrival and checked.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import resolve_device
from .cluster.device_store import DeviceShardCache, ShardKey, as_ref

Entries = Dict[ShardKey, Tuple[np.ndarray, Optional[int]]]


def shard_cache_from_numpy(entries: Entries, device=None,
                           owner: Optional[int] = None) -> DeviceShardCache:
    """A DeviceShardCache on ``device`` holding ``entries``."""
    dev = resolve_device(device)
    cache = DeviceShardCache(owner)
    for key, (words, csum) in entries.items():
        arr = torch.tensor(np.ascontiguousarray(words).reshape(-1),
                           device=dev)
        cache.put(key, as_ref(arr), csum)
    return cache


def shard_cache_to_numpy(cache: DeviceShardCache) -> Entries:
    """The inverse of shard_cache_from_numpy."""
    return {key: (ref.materialize().cpu().numpy(), csum)
            for key, ref, csum in cache.items()}


# ------------------------------------------------------------ CRUSH map --

_TUNABLES = ("choose_local_tries", "choose_local_fallback_tries",
             "choose_total_tries", "chooseleaf_descend_once",
             "chooseleaf_vary_r", "chooseleaf_stable", "straw_calc_version",
             "allowed_bucket_algs")
_RULE_FIELDS = ("name", "ruleset", "type", "min_size", "max_size")


def _ints(v) -> Optional[np.ndarray]:
    return None if v is None else np.asarray(v, dtype=np.int64)


def crush_map_state(cmap) -> dict:
    """A CrushMap of either package as plain ints and NumPy arrays."""
    buckets = []
    for b in cmap.buckets:
        if b is None:
            buckets.append(None)
            continue
        buckets.append({
            "id": int(b.id), "alg": int(b.alg), "type": int(b.type),
            "hash": int(b.hash), "items": _ints(b.items),
            "weights": _ints(b.weights), "straws": _ints(b.straws),
            "sum_weights": _ints(b.sum_weights),
            "node_weights": _ints(b.node_weights),
            "num_nodes": int(b.num_nodes)})
    rules = []
    for r in cmap.rules:
        if r is None:
            rules.append(None)
            continue
        rules.append({"steps": [tuple(int(v) for v in s) for s in r.steps],
                      **{f: getattr(r, f) for f in _RULE_FIELDS}})
    choose_args = {}
    for key, args in cmap.choose_args.items():
        choose_args[key] = [
            None if a is None else
            {"ids": _ints(a.ids),
             "weight_set": _ints(a.weight_set)}
            for a in args]
    return {
        "tunables": {f: int(getattr(cmap.tunables, f)) for f in _TUNABLES},
        "max_devices": int(cmap.max_devices),
        "buckets": buckets, "rules": rules, "choose_args": choose_args,
        "type_names": dict(cmap.type_names),
        "bucket_names": dict(cmap.bucket_names),
        "device_names": dict(cmap.device_names),
        "device_classes": dict(cmap.device_classes),
        "class_bucket_ids": dict(cmap.class_bucket_ids)}


def _list(v):
    return None if v is None else [int(x) for x in np.asarray(v).tolist()]


def crush_map_from_state(state: dict):
    """The port's CrushMap for ``crush_map_state``'s output, derived
    tables included as they were (nothing is recomputed)."""
    from .placement.crush_map import (Bucket, ChooseArg, CrushMap, Rule,
                                      Tunables)
    cmap = CrushMap(tunables=Tunables(**state["tunables"]),
                    max_devices=int(state["max_devices"]))
    for b in state["buckets"]:
        if b is None:
            cmap.buckets.append(None)
            continue
        cmap.buckets.append(Bucket(
            id=b["id"], alg=b["alg"], type=b["type"],
            items=_list(b["items"]), weights=_list(b["weights"]),
            hash=b["hash"], straws=_list(b["straws"]),
            sum_weights=_list(b["sum_weights"]),
            node_weights=_list(b["node_weights"]),
            num_nodes=b["num_nodes"]))
    for r in state["rules"]:
        cmap.rules.append(None if r is None else Rule(
            steps=[tuple(s) for s in r["steps"]],
            **{f: r[f] for f in _RULE_FIELDS}))
    for key, args in state["choose_args"].items():
        cmap.choose_args[key] = [
            None if a is None else ChooseArg(
                ids=_list(a["ids"]),
                weight_set=None if a["weight_set"] is None else
                [_list(row) for row in a["weight_set"]])
            for a in args]
    for f in ("type_names", "bucket_names", "device_names",
              "device_classes", "class_bucket_ids"):
        setattr(cmap, f, dict(state[f]))
    return cmap


# --------------------------------------------------------------- OSDMap --

def osdmap_state(om) -> dict:
    """An OSDMap of either package as plain values and NumPy arrays."""
    pools = {}
    for pid, pool in om.pools.items():
        fields = {f.name: getattr(pool, f.name)
                  for f in dataclasses.fields(pool)}
        fields["snaps"] = dict(fields["snaps"])
        pools[int(pid)] = fields
    return {
        "crush": crush_map_state(om.crush), "epoch": int(om.epoch),
        "max_osd": int(om.max_osd),
        "osd_exists": np.array(om.osd_exists, dtype=bool),
        "osd_up": np.array(om.osd_up, dtype=bool),
        "osd_weight": np.array(om.osd_weight, dtype=np.int64),
        "osd_primary_affinity": np.array(om.osd_primary_affinity,
                                         dtype=np.int64),
        "pools": pools, "flags": set(om.flags),
        "pool_id_max": int(om.pool_id_max),
        "pg_temp": {k: list(v) for k, v in om.pg_temp.items()},
        "primary_temp": dict(om.primary_temp),
        "pg_upmap": {k: list(v) for k, v in om.pg_upmap.items()},
        "pg_upmap_items": {k: [tuple(p) for p in v]
                           for k, v in om.pg_upmap_items.items()}}


def osdmap_from_state(state: dict, device=None):
    """The port's OSDMap for ``osdmap_state``'s output; its batched
    mapper runs on ``device`` (the package default when None)."""
    from .cluster.osdmap import OSDMap, PGPool
    om = OSDMap(crush_map_from_state(state["crush"]),
                max_osd=state["max_osd"], epoch=state["epoch"],
                device=device)
    for f in ("osd_exists", "osd_up", "osd_weight",
              "osd_primary_affinity"):
        getattr(om, f)[:] = state[f]
    for pid, fields in state["pools"].items():
        om.pools[pid] = PGPool(**{**fields, "snaps": dict(fields["snaps"])})
    om.flags = set(state["flags"])
    om.pool_id_max = state["pool_id_max"]
    om.pg_temp = {k: list(v) for k, v in state["pg_temp"].items()}
    om.primary_temp = dict(state["primary_temp"])
    om.pg_upmap = {k: list(v) for k, v in state["pg_upmap"].items()}
    om.pg_upmap_items = {k: [tuple(p) for p in v]
                         for k, v in state["pg_upmap_items"].items()}
    return om


# ---------------------------------------------------------------- Csums --

def csums_state(cs) -> dict:
    """A ``crcutil.Csums`` of either package as plain ints."""
    return {"block": int(cs.block), "subs": [int(c) for c in cs.subs],
            "length": int(cs.length), "combined": int(cs.combined)}


def csums_from_state(state: dict, cls=None):
    """A Csums for ``csums_state``'s output: the port's, or ``cls``
    (the reference's ``crcutil.Csums``, handed in by a caller that has
    it).  The combined crc is derived from the sub-crcs and must equal
    the one carried."""
    if cls is None:
        from .common.crcutil import Csums as cls
    cs = cls(state["block"], list(state["subs"]), state["length"])
    if cs.combined != state["combined"]:
        raise ValueError(f"csums state: sub-crcs combine to "
                         f"{cs.combined:#x}, carried {state['combined']:#x}")
    return cs
