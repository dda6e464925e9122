"""Set-up: imports, the kernels from the checkout's cache, the map, the
payloads, any prefill and the warm-up, in seconds."""


def read(run):
    return run["setup_s"]
