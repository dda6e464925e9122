"""K1 launches (ops/xor_kernel.launches) per read."""


def read(run):
    n = sum(op["kind"] == "get" for op in run["ops"])
    return run["work"]["k1_launches"] / n if n else None
