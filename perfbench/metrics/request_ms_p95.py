"""95th percentile of every answered request of the window, each timed
from when it was due until its logits were on the host, in ms."""
from perfbench import loadgen


def read(run):
    lat = [r.latency_s * 1e3 for r in run.requests if r.answered]
    return loadgen.percentile(lat, 95) if lat else None
