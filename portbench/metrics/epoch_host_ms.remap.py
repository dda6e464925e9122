"""The host's own work of a map epoch, around the card's: the spans
``osdmap.apply_incremental``, ``osdmap.pps``, ``osdmap.post_crush`` and
``crush.native_fallback``, in ms an epoch (each epoch is one sweep)."""
from portbench import spans

STAGES = {"osdmap.apply_incremental", "osdmap.pps", "osdmap.post_crush",
          "crush.native_fallback"}


def read(run):
    return spans.per_op_ms(run, "sweep", STAGES, "duration_s")
