"""95th percentile (nearest rank) of every read's latency in the window,
in ms; the sample count is the result's ``attempted``."""
import portbench.readers as r


def read(run):
    v = r.p95(r.latencies(run, "get"))
    return None if v is None else 1e3 * v
