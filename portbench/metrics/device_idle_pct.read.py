"""Share of the traced window with nothing on the card (%)."""
import portbench.readers as r


def read(run):
    return r.idle_pct(run)
