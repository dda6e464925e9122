"""Bytes of objects whose every shard acked, over the window (GB/s)."""


def read(run):
    return run["work"]["bytes_acked"] / run["window_s"] / 1e9
