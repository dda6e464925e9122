"""The 'lrc' codec — layered locally-repairable erasure coding.

Re-creates the behavior of the reference LRC plugin
(src/erasure-code/lrc/ErasureCodeLrc.{h,cc}): a global ``mapping`` string
assigns each chunk position a role ('D' data, 'c' coding, '_' padding
hole), and ``layers`` — a JSON list of [chunks_map, profile] pairs — each
run an inner codec over their own 'D'/'c' positions (layers_init,
ErasureCodeLrc.cc:213-244).  Single-chunk failures repair from the
smallest covering layer instead of reading k chunks: _minimum_to_decode
walks layers in reverse preferring local groups (ErasureCodeLrc.cc:590+).

The k/m/l shorthand (DEFAULT_KML generation, ErasureCodeLrc.cc:347-367)
builds the canonical mapping: k data + m global parities followed by one
local parity per group of (k+m)/... — matching the reference's generated
layout.

Profiles:
  plugin=lrc mapping=__DD__DD layers=[["_cDD_cDD",""],["cDDD____",""],...]
  plugin=lrc k=4 m=2 l=3     (generated layout)

Port of ``ceph_tpu/ec/plugin_lrc.py``.  The LRC codec is built on the
caller's device (the package default when None) and builds every layer's
codec on that same device, so a layer of the default ``jax`` plugin
(layout=bytes) runs each of its stripe operations as one call of kernel
K2 on a CUDA device.
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence, Set

import numpy as np

from .. import resolve_device
from .base import ErasureCodeBase
from .interface import ErasureCodeError, ErasureCodeProfile, SubChunkPlan


class _Layer:
    def __init__(self, chunks_map: str, profile: Dict[str, str], device):
        self.chunks_map = chunks_map
        self.data = [i for i, c in enumerate(chunks_map) if c == "D"]
        self.coding = [i for i, c in enumerate(chunks_map) if c == "c"]
        self.chunks = self.data + self.coding
        self.chunks_as_set = set(self.chunks)
        self.profile = dict(profile)
        self.profile.setdefault("k", str(len(self.data)))
        self.profile.setdefault("m", str(len(self.coding)))
        self.profile.setdefault("plugin", "jax")
        self.profile.setdefault("technique", "reed_sol_van")
        from .registry import ErasureCodePluginRegistry
        self.codec = ErasureCodePluginRegistry.instance().factory(
            self.profile["plugin"], self.profile, device=device)


def _generate_kml(k: int, m: int, l: int) -> Dict[str, str]:
    """The k/m/l layout generator (ErasureCodeLrc.cc:293-375 semantics):
    groups of l data-or-global-coding chunks each get one local parity."""
    if l <= 0 or (k + m) % l:
        raise ErasureCodeError(
            f"lrc k+m={k + m} must be a multiple of l={l}")
    local_group_count = (k + m) // l
    if k % local_group_count or m % local_group_count:
        raise ErasureCodeError(
            f"lrc k={k} and m={m} must be multiples of the group count "
            f"{local_group_count}")
    kg = k // local_group_count
    mg = m // local_group_count
    mapping = ("D" * kg + "_" * mg + "_") * local_group_count
    # global layer: all data positions, coding in the per-group m slots
    glob = ""
    for g in range(local_group_count):
        glob += "D" * kg + "c" * mg + "_"
    layers: List[List[str]] = [[glob, ""]]
    # one local parity layer per group covering its k+m slots
    for g in range(local_group_count):
        pre = "_" * (g * (kg + mg + 1))
        post = "_" * ((local_group_count - g - 1) * (kg + mg + 1))
        layers.append([pre + "D" * (kg + mg) + "c" + post, ""])
    return {"mapping": mapping, "layers": json.dumps(layers)}


class ErasureCodeLrc(ErasureCodeBase):
    def __init__(self, device=None) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self.layers: List[_Layer] = []
        self.mapping = ""

    def init(self, profile: ErasureCodeProfile) -> None:
        prof = dict(profile)
        self._crush_profile = dict(profile)
        if "mapping" not in prof:
            k = self.profile_int(prof, "k", 4, minimum=1)
            m = self.profile_int(prof, "m", 2, minimum=1)
            l = self.profile_int(prof, "l", 3, minimum=1)
            prof.update(_generate_kml(k, m, l))
        self.mapping = prof["mapping"]
        try:
            layer_desc = json.loads(prof["layers"])
        except (KeyError, json.JSONDecodeError) as e:
            raise ErasureCodeError(f"lrc layers JSON invalid: {e}") from e
        if not isinstance(layer_desc, list) or not layer_desc:
            raise ErasureCodeError("lrc layers must be a non-empty list")
        n = len(self.mapping)
        self.layers = []
        for entry in layer_desc:
            cmap = entry[0] if isinstance(entry, list) else entry
            lprof: Dict[str, str] = {}
            if isinstance(entry, list) and len(entry) > 1 and entry[1]:
                if isinstance(entry[1], str):
                    for kv in entry[1].split():
                        key, _, val = kv.partition("=")
                        lprof[key] = val
                elif isinstance(entry[1], dict):
                    lprof = {k: str(v) for k, v in entry[1].items()}
            if len(cmap) != n:
                raise ErasureCodeError(
                    f"layer map {cmap!r} length != mapping length {n}")
            self.layers.append(_Layer(cmap, lprof, self.device))
        covered = set()
        for lay in self.layers:
            covered |= lay.chunks_as_set
        if covered != set(range(n)):
            raise ErasureCodeError(
                f"layers cover {sorted(covered)} != all {n} positions")
        self.k = sum(1 for c in self.mapping if c == "D")
        self.m = n - self.k
        # logical chunk ids: 0..k-1 data, k.. the rest; physical = the
        # position in the mapping string (what placement distributes)
        self._l2p = [i for i, c in enumerate(self.mapping) if c == "D"] + \
            [i for i, c in enumerate(self.mapping) if c != "D"]
        self._p2l = {p: i for i, p in enumerate(self._l2p)}
        self._profile = dict(profile)
        self._profile.setdefault("plugin", "lrc")

    def get_chunk_mapping(self) -> List[int]:
        return list(self._l2p)

    # ------------------------------------------------------------ encode --
    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        data = np.asarray(data_chunks, dtype=np.uint8)
        if data.shape[0] != self.k:
            raise ErasureCodeError(
                f"expected {self.k} data chunks, got {data.shape[0]}")
        n = len(self.mapping)
        chunk = data.shape[1]
        full = np.zeros((n, chunk), dtype=np.uint8)
        data_pos = [i for i, c in enumerate(self.mapping) if c == "D"]
        for i, pos in enumerate(data_pos):
            full[pos] = data[i]
        # layers run in order; later layers may consume earlier codings
        for lay in self.layers:
            sub = full[lay.data]
            parity = lay.codec.encode_chunks(sub)
            for j, pos in enumerate(lay.coding):
                full[pos] = parity[j]
        non_data = [i for i in range(n) if i not in data_pos]
        return full[non_data]

    # ------------------------------------------------------------ decode --
    def minimum_to_decode(self, want_to_read: Set[int],
                          available: Set[int]) -> SubChunkPlan:
        """Smallest covering layer first (ErasureCodeLrc.cc Case 1-3).
        Ids are logical; layers work in physical positions."""
        erasures_want = want_to_read - available
        if not erasures_want:
            return {c: [(0, 1)] for c in want_to_read}
        want_p = {self._l2p[c] for c in want_to_read}
        avail_p = {self._l2p[c] for c in available}
        # accumulate per-layer reads, most-local layers first, removing
        # erasures as a layer promises to recover them (Case 2,
        # ErasureCodeLrc.cc); wanted-and-available chunks always read
        minimum_p = want_p & avail_p
        era_not_recovered = set(range(len(self.mapping))) - avail_p
        era_want = {self._l2p[c] for c in erasures_want}
        for lay in reversed(self.layers):
            if not era_want:
                break
            layer_erasures = era_want & lay.chunks_as_set
            if not layer_erasures:
                continue
            unrecovered_in_layer = lay.chunks_as_set & era_not_recovered
            if len(unrecovered_in_layer) > len(lay.coding):
                continue            # too many for this layer; try a wider one
            minimum_p |= lay.chunks_as_set & avail_p
            era_not_recovered -= unrecovered_in_layer
            era_want -= layer_erasures
        if not era_want:
            return {self._p2l[c]: [(0, 1)] for c in minimum_p}
        # fall back: any combination across layers that can cascade-recover
        if self._can_recover(avail_p):
            return {self._p2l[c]: [(0, 1)] for c in avail_p}
        raise ErasureCodeError(
            f"lrc cannot recover {sorted(erasures_want)} from "
            f"{sorted(available)}")

    def _can_recover(self, available: Set[int]) -> bool:
        have = set(available)
        progress = True
        while progress:
            progress = False
            for lay in self.layers:
                missing = lay.chunks_as_set - have
                if missing and len(missing) <= len(lay.coding) and \
                        len(lay.chunks_as_set & have) >= len(lay.data):
                    have |= lay.chunks_as_set
                    progress = True
        return have >= set(range(len(self.mapping)))

    def decode_chunks(self, available_ids: Sequence[int],
                      chunks: np.ndarray, erased_ids: Sequence[int]
                      ) -> np.ndarray:
        """Cascading layer repair: repeatedly fix any layer with few
        enough erasures until targets are rebuilt.  Ids logical."""
        chunk = chunks.shape[-1]
        have: Dict[int, np.ndarray] = {
            self._l2p[c]: np.asarray(chunks[i], dtype=np.uint8)
            for i, c in enumerate(available_ids)}
        targets = [self._l2p[c] for c in sorted(erased_ids)]
        progress = True
        while progress and not all(t in have for t in targets):
            progress = False
            for lay in self.layers:
                missing = [c for c in lay.chunks if c not in have]
                if not missing:
                    continue
                avail_in = [c for c in lay.chunks if c in have]
                if len(avail_in) < len(lay.data) or \
                        len(missing) > len(lay.coding):
                    continue
                # express in layer-local indices
                local = {g: i for i, g in enumerate(lay.chunks)}
                try:
                    rebuilt = lay.codec.decode_chunks(
                        [local[c] for c in avail_in],
                        np.stack([have[c] for c in avail_in]),
                        [local[c] for c in missing])
                except ErasureCodeError:
                    continue
                for i, c in enumerate(sorted(missing,
                                             key=lambda g: local[g])):
                    have[c] = rebuilt[i]
                progress = True
        try:
            return np.stack([have[t] for t in targets]) if targets else \
                np.zeros((0, chunk), dtype=np.uint8)
        except KeyError as e:
            raise ErasureCodeError(
                f"lrc unrecoverable chunk {e} from {sorted(available_ids)}"
            ) from e


def lrc_crush_rule(codec: "ErasureCodeLrc", cmap, root_name: str = None):
    """Generate the locality-aware CRUSH rule for an LRC pool
    (ErasureCodeLrc::create_rule semantics, ErasureCodeLrc.h:127 /
    ErasureCodeLrc.cc create_rule): place one local group per
    `crush-locality` bucket, spreading the group's chunks across
    `crush-failure-domain` buckets inside it — so a local repair never
    leaves its locality domain.

    Profile keys (reference names): `crush-root` (default "default"),
    `crush-locality` (e.g. "rack"; omitted -> flat rule),
    `crush-failure-domain` (default "host").  Returns the ruleno added
    to ``cmap``.
    """
    from ..placement.crush_map import (
        Rule, RULE_CHOOSELEAF_INDEP, RULE_CHOOSE_INDEP, RULE_EMIT,
        RULE_TAKE)
    prof = getattr(codec, "_crush_profile", {})
    type_by_name = {v: k for k, v in cmap.type_names.items()}
    root_name = root_name or prof.get("crush-root", "default")
    name_to_id = {v: k for k, v in cmap.bucket_names.items()}
    if root_name not in name_to_id:
        raise ErasureCodeError(f"crush-root {root_name!r} not in map")
    root = name_to_id[root_name]
    fd_name = prof.get("crush-failure-domain", "host")
    if fd_name not in type_by_name:
        raise ErasureCodeError(
            f"crush-failure-domain {fd_name!r} not a map type")
    fd_type = type_by_name[fd_name]
    locality = prof.get("crush-locality")
    n = codec.get_chunk_count()
    steps = [(RULE_TAKE, root, 0)]
    if locality:
        if locality not in type_by_name:
            raise ErasureCodeError(
                f"crush-locality {locality!r} not a map type")
        # group structure comes from the k/m/l profile (the generated
        # layout guarantees one local group per (k+m)/l slice); custom
        # layer JSONs have no inferable grouping — layer-list
        # arithmetic would mislabel extra global layers as groups
        if not all(key in prof for key in ("k", "m", "l")):
            raise ErasureCodeError(
                "lrc locality rule needs the k/m/l profile; custom "
                "layer JSONs must supply their own crush rule")
        k = int(prof["k"])
        m = int(prof["m"])
        l = int(prof["l"])
        if l <= 0 or (k + m) % l:
            raise ErasureCodeError(
                f"lrc: k+m={k + m} not a multiple of l={l}")
        groups = (k + m) // l
        if groups <= 0 or n % groups:
            raise ErasureCodeError(
                f"lrc: {n} chunks not divisible into {groups} groups")
        per_group = n // groups
        # sanity: every local layer must sit inside one group slice
        for L in codec.layers[1:]:
            lo = min(L.chunks_as_set)
            hi = max(L.chunks_as_set)
            if lo // per_group != hi // per_group:
                raise ErasureCodeError(
                    "lrc: a local layer spans group boundaries; "
                    "cannot generate a locality rule")
        steps.append((RULE_CHOOSE_INDEP, groups,
                      type_by_name[locality]))
        steps.append((RULE_CHOOSELEAF_INDEP, per_group, fd_type))
    else:
        steps.append((RULE_CHOOSELEAF_INDEP, 0, fd_type))
    steps.append((RULE_EMIT, 0, 0))
    return cmap.add_rule(Rule(steps=steps, name="lrc_rule", type=3))


def _factory(profile: ErasureCodeProfile, device=None):
    codec = ErasureCodeLrc(device)
    codec.init(profile)
    return codec


def register(registry) -> None:
    registry.add("lrc", _factory)
