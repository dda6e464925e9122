"""The stream's time in the fast mapper's collision and out resolve and
its emit (``crush.fastmap.resolve``, ``crush.fastmap.emit``), in ms a
sweep: their kernels plus the card's idle between them while the host
launches the resolve's many small ops, so it follows the host's pace
too, not the kernels' alone."""
from portbench import spans


def read(run):
    return spans.per_op_ms(run, "sweep", {"crush.fastmap.resolve",
                                          "crush.fastmap.emit"}, "device_s")
