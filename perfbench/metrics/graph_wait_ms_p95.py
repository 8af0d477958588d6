"""95th percentile over the traced stretch's requests of each request's
summed ``executor.graph_wait`` span, in ms: the time it waited for a
captured forward's table and bucket locks (another request of the same
bucket holding its graph), read from the port's own spans."""
from perfbench import program_spans


def read(run):
    return program_spans.p95_ms(run, "executor.graph_wait")
