"""The host's own time per served forward in the traced stretch, in ms:
each request's ``serving.infer`` span less its ``serving.sync``, summed
and over the forwards (a request's chunks); read from the port's own
spans.  In a one-client closed loop it is the most device idle the
program itself can cause."""
from perfbench import program_spans


def read(run):
    return program_spans.per_forward_ms(run, program_spans.ROOT,
                                        less="serving.sync")
