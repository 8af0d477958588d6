"""95th percentile over the window's requests of how late the load
generator sent each one: send time minus due time, in ms (a loop that
sends on a schedule; a closed loop sends each request when it is due)."""
from perfbench import loadgen


def read(run):
    if run.cell.mix["loop"] == "closed" or not run.requests:
        return None
    return loadgen.percentile([r.late_s * 1e3 for r in run.requests], 95)
