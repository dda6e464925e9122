"""Median time of one Objecter.get (ms)."""
import portbench.readers as r


def read(run):
    v = r.p50(r.latencies(run, "get"))
    return None if v is None else 1e3 * v
