"""The card's time in the fast mapper's descents (``crush.fastmap.descend``:
the straw2 walk, rjenkins hash3 and the draw, level by level), in ms a
sweep.  It is the stream's time between the span's entry and its exit;
the host issues a descent's kernels far ahead of the card, so nearly all
of it is the kernels' own."""
from portbench import spans


def read(run):
    return spans.per_op_ms(run, "sweep", {"crush.fastmap.descend"},
                           "device_s")
