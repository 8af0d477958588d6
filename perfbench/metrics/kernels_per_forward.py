"""Device operations per served forward in the traced stretch: the
profiler's kernel, memcpy and memset records on the cell's cards over the
forwards of the stretch's requests (one a request up to the largest
bucket).  Shared by ``kernels_per_forward.offline`` and
``kernels_per_forward.online``."""


def read(run):
    forwards = run.forwards(run.traced)
    if run.trace is None or not run.trace.launches or not forwards:
        return None
    return run.trace.launches / forwards
