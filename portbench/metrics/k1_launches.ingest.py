"""K1 launches (ops/xor_kernel.launches) per GiB acked."""
import portbench.readers as r


def read(run):
    w = run["work"]
    return r.per_gib(w["k1_launches"], w["bytes_acked"])
