"""Bytes of objects read in the window, over the window (GB/s)."""


def read(run):
    return run["work"]["bytes_read"] / run["window_s"] / 1e9
