"""The sweep's share of its roofline (%): the least time of the straw2
draws that the reference needs for these inputs (retries included) at
the card's 32-bit integer rate, or of one read of the crush_ln table a
sweep at its HBM rate, whichever is larger, over the device's busy time
in the window."""
from portbench import arith


def read(run):
    t, w = run["trace"], run["work"]
    if not t or "draws" not in w:
        return None
    sweeps = sum(op["kind"] == "sweep" for op in run["ops"])
    return arith.roofline_pct(arith.placement_least_s(w["draws"], sweeps),
                              t["busy_s"])
