"""The data-parallel forward's batch |max| exchanges per served forward
in the traced stretch, in ms: the summed ``executor.exchange`` spans (one
a GEMM segment boundary: the reduction over the cards and the copies of
the scale back to each) over the forwards; read from the port's own
spans."""
from perfbench import program_spans


def read(run):
    return program_spans.per_forward_ms(run, "executor.exchange")
