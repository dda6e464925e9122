"""Carry staged EC state between the reference package and the port.

State crosses as NumPy: ``entries`` maps a ShardKey to ``(words, csum)``,
where ``words`` is one shard's flat int32 plane words (the reference
package's staged shard read out with ``np.asarray(ref.materialize())``)
and ``csum`` its durable checksum, or None for a dirty entry.  Codec
parameters cross as the profile dict: one profile builds the same codec
in both packages.
"""
from __future__ import annotations

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
