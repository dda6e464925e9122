"""PGs mapped by the window's sweeps, over the window (PGs/s)."""


def read(run):
    return run["work"]["pgs_mapped"] / run["window_s"]
