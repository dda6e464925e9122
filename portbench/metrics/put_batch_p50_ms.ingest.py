"""Median time of one Objecter.put_many batch, retries included (ms)."""
import portbench.readers as r


def read(run):
    v = r.p50(r.latencies(run, "put_many"))
    return None if v is None else 1e3 * v
