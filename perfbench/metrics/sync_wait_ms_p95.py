"""95th percentile over the traced stretch's requests of each request's
``serving.sync`` span, in ms: the device-wide synchronize that ends a
request, which also waits for work other requests queued after its own;
read from the port's own spans."""
from perfbench import program_spans


def read(run):
    return program_spans.p95_ms(run, "serving.sync")
