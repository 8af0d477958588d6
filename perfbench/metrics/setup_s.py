"""Process start to the first timed request, in s: imports, CUDA start,
weights and images drawn, plans, the cell's buckets captured (and on a
checkout's first run, the kernels' build)."""


def read(run):
    return run.setup_s
